"""End-to-end training CLI of the port, on the CUDA card
(``--device cpu`` runs it on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --preset tiny --steps 200 --ckpt-dir /tmp/ckpt

The JAX package's ``launch/train.py`` with the same flags, presets, log
lines, checkpoint cadence and resume, plus ``--device``.  The presets cut
a registered config to a size one device trains quickly (``full`` keeps
it as registered); an MoE, MLA, SSM or encoder-decoder config gets the
same smaller widths as in the JAX package.

Fault tolerance: a checkpoint every ``--ckpt-every`` steps (atomic,
async), and a restart resumes from the newest one, the data stream from
the same step.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import data_iter
from repro_torch.training.train_step import (as_tensors, init_train_state,
                                             make_train_step)

PRESETS = {
    # ~20M / ~100M substitutes runnable on one device
    "tiny": dict(d_model=384, n_layers=8, n_heads=6, n_kv_heads=2, head_dim=64,
                 d_ff=1024, vocab_size=4096, batch=4, seq=256),
    "100m": dict(d_model=640, n_layers=12, n_heads=10, n_kv_heads=2,
                 head_dim=64, d_ff=1792, vocab_size=8192, batch=8, seq=512),
    "full": dict(),
}


def preset_config(arch: str, preset: str):
    """(config, batch size, sequence length) of `arch` under `preset`."""
    cfg = get_config(arch)
    preset = dict(PRESETS[preset])
    batch_size = preset.pop("batch", 4)
    seq_len = preset.pop("seq", 256)
    if preset:
        if cfg.is_moe:
            preset.update(n_experts=min(cfg.n_experts, 8),
                          top_k=min(cfg.top_k, 2), d_expert=256,
                          n_shared_experts=min(cfg.n_shared_experts, 1))
        if cfg.attn == "mla":
            preset.update(kv_lora_rank=64,
                          q_lora_rank=96 if cfg.q_lora_rank else 0,
                          qk_rope_dim=32, qk_nope_dim=32, v_head_dim=64,
                          head_dim=64)
        if cfg.family in ("ssm", "hybrid"):
            preset.update(ssm_state=16, ssm_headdim=32, ssm_chunk=64)
        if cfg.encoder_decoder:
            preset.update(n_enc_layers=4, enc_seq_len=64)
        cfg = dataclasses.replace(cfg, **preset)
    return cfg, batch_size, seq_len


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--moe-impl", default="einsum",
                    choices=["einsum", "scatter"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; 'cpu' trains on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg, batch_size, seq_len = preset_config(args.arch, args.preset)
    shape = ShapeConfig("train", seq_len, batch_size, "train")
    dev = resolve_device(args.device)

    print(f"arch={cfg.name} params≈{cfg.param_counts()['total']/1e6:.1f}M "
          f"batch={batch_size} seq={seq_len} steps={args.steps}")

    params = init_params(cfg, seed=0, device=dev)
    state = init_train_state(params, grad_compress=args.grad_compress)
    step_fn = make_train_step(
        cfg, lr=args.lr, warmup=20, total_steps=args.steps,
        moe_impl=args.moe_impl, grad_compress=args.grad_compress)

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3, async_write=True)
        if mgr.latest_step() is not None:
            restored, start, extra = mgr.restore(state._asdict(), device=dev)
            state = type(state)(**restored)
            print(f"resumed from step {start}")

    it = data_iter(cfg, shape, seed=0, start_step=start)
    t0 = time.time()
    for i in range(start, args.steps):
        batch = as_tensors(next(it), cfg, dev)
        state, m = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"nll={float(m['nll']):.4f} gnorm={float(m['gnorm']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/max(1,i-start+1):.2f}s/step)")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state._asdict(), extra={"loss": float(m["loss"])})
    if mgr:
        mgr.save(args.steps, state._asdict())
        mgr.wait()
    print(f"done in {time.time()-t0:.1f}s; final loss {float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
