from repro_torch.models.model import decode_step, init_cache, init_params

__all__ = ["decode_step", "init_cache", "init_params"]
