"""Prefill + decode generation for the *resident-params* path (greedy or
temperature sampling): the fully in-memory baseline every ZipMoE result is
checked against.

API:
  sample_tokens(logits, generator, temperature) — [B, V] -> [B] int64;
      argmax at temperature 0, else one categorical draw per row from
      `generator` (a ``torch.Generator`` on the logits' device).
  make_steps(cfg, moe_impl=...)   — (prefill_fn, decode_fn), plain
      functions over ``models.prefill`` / ``models.decode_step``.
  generate(params, cfg, prompt, ...) — end-to-end prefill + N decode steps
      with KV-cache growth (``serving/kv_cache.grow_cache``);
      ``extra_inputs`` (an encoder-decoder's ``enc_embeds``) go to the
      prefill.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import decode_step, prefill
from repro_torch.serving.kv_cache import grow_cache


def sample_tokens(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0) -> torch.Tensor:
    """logits: [B, V] -> [B] int64 on the logits' device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_generator(device, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on `device` seeded with `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def make_steps(cfg, *, moe_impl="einsum"):
    """(prefill_fn(params, tokens, **inputs), decode_fn(params, tokens,
    caches, pos)); ``inputs`` are :func:`models.prefill`'s keywords."""
    def pf(params, tokens, **inputs):
        return prefill(params, cfg, tokens, moe_impl=moe_impl, **inputs)

    def dec(params, tokens, caches, pos):
        return decode_step(params, cfg, tokens, caches, pos)

    return pf, dec


def generate(params, cfg, prompt, *, max_new_tokens: int = 32,
             temperature: float = 0.0, seed: int = 0,
             extra_inputs: Optional[Dict] = None, steps=None
             ) -> Tuple[np.ndarray, Dict[str, float]]:
    """prompt: [B, S] int; extra_inputs: keyword inputs of the prefill (an
    encoder-decoder's ``{"enc_embeds": [B, Se, d]}``; the decode steps
    read the encoder's K/V from the cache).  Returns (tokens [B, S+new]
    on the host, timing metrics).  A step ends when its tokens are on the
    host."""
    dev = params["embed"]["tok"].device
    prompt = torch.as_tensor(prompt, device=dev).long()
    B, S = prompt.shape
    pf, dec = steps or make_steps(cfg)
    gen = make_generator(dev, seed)

    t0 = time.perf_counter()
    logits, caches = pf(params, prompt, **(extra_inputs or {}))
    caches = grow_cache(cfg, caches, B, S + max_new_tokens)
    next_tok = sample_tokens(logits[:, -1], gen, temperature)
    out = [next_tok.cpu()]
    ttft = time.perf_counter() - t0

    t1 = time.perf_counter()
    for i in range(max_new_tokens - 1):
        lg, caches = dec(params, next_tok[:, None], caches, S + i)
        next_tok = sample_tokens(lg[:, -1], gen, temperature)
        out.append(next_tok.cpu())
    tpot = (time.perf_counter() - t1) / max(1, max_new_tokens - 1)
    tokens = torch.cat([prompt.cpu(), torch.stack(out, dim=1)], dim=1)
    return tokens.numpy(), {"ttft_s": ttft, "tpot_s": tpot}
