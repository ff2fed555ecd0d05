"""Synthetic token pipeline: seeded, deterministic, restart-safe.

Generates LM batches with a mixture structure (n-gram-ish transition matrix)
so the loss actually *decreases* during the example training runs — pure
uniform tokens would leave nothing to learn.  ``state`` is just (seed, step),
so checkpoint/restore resumes the stream exactly.

The JAX package's ``training/data.py``, with ``batch_spec`` taken from the
port (its dtypes are torch's): the same seeds give the same numpy arrays
in both packages.  numpy only; ``training.train_step.as_tensors`` moves a
batch onto the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.inputs import batch_spec


@dataclass
class DataState:
    seed: int
    step: int


class SyntheticLM:
    """Markov-chain token stream with a low-rank transition structure."""

    def __init__(self, vocab_size: int, seed: int = 0, rank: int = 16):
        self.V = vocab_size
        rng = np.random.default_rng(seed ^ 0x5eed)
        r = min(rank, vocab_size)
        a = rng.standard_normal((vocab_size, r)) / np.sqrt(r)
        b = rng.standard_normal((r, vocab_size)) / np.sqrt(r)
        # sharp transitions (conditional entropy ≈ 2-3 nats) so short example
        # runs show clear learning
        logits = (a @ b) * 10.0
        self.probs = np.exp(logits - logits.max(1, keepdims=True))
        self.probs /= self.probs.sum(1, keepdims=True)
        self.seed = seed

    def batch(self, step: int, batch_size: int, seq_len: int
              ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.V, batch_size)
        # vectorised Markov sampling via inverse-CDF per column
        cdf = np.cumsum(self.probs, axis=1)
        for t in range(seq_len):
            u = rng.random(batch_size)[:, None]
            toks[:, t + 1] = (u > cdf[toks[:, t]]).sum(1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def data_iter(cfg, shape, *, seed: int = 0, start_step: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
    """Yields batches matching models.inputs.batch_spec(cfg, shape, 'train')."""
    gen = SyntheticLM(cfg.vocab_size, seed)
    spec = batch_spec(cfg, shape, "train")
    step = start_step
    rng = np.random.default_rng(seed)
    while True:
        if "tokens" in spec:
            out = gen.batch(step, shape.global_batch, shape.seq_len)
        else:  # embed-input archs: random embeddings + random labels
            out = {}
        for name, (shp, dt) in spec.items():
            if name in out:
                continue
            if name == "mrope_positions":
                out[name] = np.broadcast_to(
                    np.arange(shp[-1], dtype=np.int32), shp).copy()
            elif not dt.is_floating_point:       # a torch dtype
                out[name] = rng.integers(0, cfg.vocab_size, shp).astype(np.int32)
            else:
                out[name] = (rng.standard_normal(shp) * 0.02).astype("float32")
        yield out
        step += 1
