"""PyTorch/CUDA port of the ZipMoE serving system (the JAX package
``repro`` is the reference it is tested against).

Imports torch and numpy only — never jax or anything of ``repro``.  Entry
points (``models.init_params``, ``core.store.build_store``,
``serving.zipserve.ZipServer``) run on the CUDA card unless the caller
passes ``device="cpu"``; CUDA tensors go through the hand-written kernels
of ``kernels/``.
"""
