"""The one traffic generator: reads a mix of ``zipbench/traffic/<name>.json``
and makes every request's sizes and tokens from the run's seed.

Sizes come from a fixed pool of ``pool`` requests: each length
distribution's quantiles at (i + 1/2) / pool, prompts paired with outputs by
a permutation from the mix's ``sizes_seed``.  The run's seed only permutes
that pool and draws the token ids, so every seed serves the same multiset of
lengths in another order, and a pool no larger than a window's requests puts
the whole of it into every window.

Keys of a mix:
  loop          "closed": a client's next request follows its last reply
  clients       requests in flight
  prompt_len, output_len   {"dist": "fixed", "value": n}
                | {"dist": "uniform", "lo": a, "hi": b}         (inclusive)
                | {"dist": "lognormal", "median": m, "sigma": s, "lo": a,
                   "hi": b}                                     (clipped)
  sizes_seed, pool         the fixed pool of sizes
  source, cut   where the lengths come from and how they were cut (text)
"""
from __future__ import annotations

import json
from pathlib import Path
from statistics import NormalDist

import numpy as np


def _quantiles(spec: dict, n: int) -> np.ndarray:
    """The distribution's quantiles at (i + 1/2) / n, i = 0 .. n - 1."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if kind == "uniform":
        lo, hi = int(spec["lo"]), int(spec["hi"])
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
        return np.clip(np.rint(x), spec["lo"], spec["hi"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {kind!r}")


def load(root, name: str) -> dict:
    return json.loads((Path(root) / "zipbench" / "traffic"
                       / f"{name}.json").read_text())


class Traffic:
    def __init__(self, spec: dict, seed: int, vocab: int):
        self.spec, self.seed, self.vocab = spec, int(seed), int(vocab)
        pool = int(spec["pool"])
        rng = np.random.default_rng(int(spec.get("sizes_seed", 0)))
        self.prompt_lens = _quantiles(spec["prompt_len"], pool)
        self.output_lens = _quantiles(spec["output_len"],
                                      pool)[rng.permutation(pool)]
        self.order = np.random.default_rng([self.seed, 1]).permutation(pool)

    @property
    def max_prompt(self) -> int:
        return int(self.prompt_lens.max())

    @property
    def max_output(self) -> int:
        return int(self.output_lens.max())

    def sizes(self, i: int):
        """(prompt length, output length) of request i in this seed's
        order."""
        j = self.order[i % len(self.order)]
        return int(self.prompt_lens[j]), int(self.output_lens[j])

    def request(self, i: int):
        """(prompt token ids [P] int32, output length) of request i."""
        p, n = self.sizes(i)
        rng = np.random.default_rng([self.seed, 2, i])
        return rng.integers(0, self.vocab, p).astype(np.int32), n

    def rng(self, *key) -> np.random.Generator:
        """A generator for anything else the run draws (samples, orders)."""
        return np.random.default_rng([self.seed, 3, *key])
