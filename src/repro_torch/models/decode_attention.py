"""Sequence-sharded decode attention, the JAX package's
``models/decode_attention.py`` for ranks of a ``DeviceMesh``.

The KV cache splits on the SEQUENCE dim over the mesh's ``model`` axis:
rank i of the axis holds positions ``[i·T_loc, (i+1)·T_loc)`` of the rows
it decodes (its cache tensors are ``T_loc = T/n`` long in dim 1).  Each
rank attends over its slice, and the ranks combine as a distributed
flash-decode: a global max of the scores (all-reduce MAX), then the
softmax normaliser and the weighted sum of values (two all-reduce SUMs) —
O(B·H·D) bytes per layer instead of moving the O(B·T·H·D) cache.  The
rank that owns ``pos`` writes the new token's K/V (MLA: its latent) in
place; ``pos`` is a host int, so that is a plain branch.

Scores, softmax and sums run in f32 on f32 inputs, as the port's
``gqa_decode``/``mla_decode`` (absorbed) compute them: the same function
added in another order.  (The JAX package's version rounds the attention
weights, and MLA's absorbed query, to the activation dtype before the
value sum; in f32 that changes nothing.)

Each function takes this rank's rows only; ``models.model.decode_step``
with ``attn_impl="seqshard"`` picks the rows of a batch split over the
mesh's data axes.  :func:`seqshard_caches` cuts a rank's caches out of
full ones.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_reduce
from repro_torch.distributed.sharding import Spec, shard_local
from repro_torch.kernels.ref import apply_rope, where_mask
from repro_torch.models.attention import (_mla_kv_latent, _mla_q, _mla_scale,
                                          _project_qkv, mla_absorb_out,
                                          mla_absorb_q)


def _shard(cache, mesh, axis):
    """(local length, first position) of this rank's slice of `cache`."""
    t_loc = next(iter(cache.values())).shape[1]
    return t_loc, mesh.get_local_rank(axis) * t_loc


def _owner_write(buf, new, pos: int, start: int):
    """Write `new` [B, 1, ...] at `pos` in place if this slice owns it."""
    rel = pos - start
    if 0 <= rel < buf.shape[1]:
        buf[:, rel] = new[:, 0].to(buf.dtype)


def _softmax_parts(sc, valid, group, ledger):
    """Masked local scores [..., T_loc] -> (exp(sc - global max), the
    global normaliser [..., 1])."""
    sc = where_mask(sc, valid)
    m = all_reduce(sc.amax(-1, keepdim=True), dist.ReduceOp.MAX, group,
                   ledger)
    pexp = torch.exp(sc - m)
    denom = all_reduce(pexp.sum(-1, keepdim=True), dist.ReduceOp.SUM,
                       group, ledger)
    return pexp, denom


def gqa_decode_seqsharded(p, x, cfg, cache, pos: int, mesh, *,
                          axis: str = "model", mrope_positions=None,
                          ledger=None):
    """x: [B, 1, d] (this rank's rows); cache k/v: [B, T_loc, Hkv, D], this
    rank's slice along `axis`; pos: the new token's global index;
    mrope_positions: [3, B, 1] or None.  Returns (y [B, 1, d], cache),
    the cache updated in place.  Three all-reduces over `axis`: the max
    and the normaliser [B, Hkv, G, 1, 1] and the numerator [B, 1, Hkv, G,
    D], all f32."""
    B = x.shape[0]
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, posv, mrope_positions)
    t_loc, start = _shard(cache, mesh, axis)
    _owner_write(cache["k"], k, pos, start)
    _owner_write(cache["v"], v, pos, start)
    group = mesh.get_group(axis)
    qf = q.float().reshape(B, 1, Hkv, G, hd)
    sc = torch.einsum("bshgd,bthd->bhgst", qf, cache["k"].float())
    sc = sc / math.sqrt(hd)
    valid = (start + torch.arange(t_loc, device=x.device)) <= pos
    pexp, denom = _softmax_parts(sc, valid, group, ledger)
    num = all_reduce(torch.einsum("bhgst,bthd->bshgd", pexp,
                                  cache["v"].float()),
                     dist.ReduceOp.SUM, group, ledger)
    out = (num / denom.movedim(-1, 1)).to(x.dtype)
    y = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    return y, cache


def mla_decode_seqsharded(p, x, cfg, cache, pos: int, mesh, *,
                          axis: str = "model", ledger=None):
    """Absorbed MLA decode over this rank's latent slice.  x: [B, 1, d];
    cache ``{"ckv": [B, T_loc, C], "k_rope": [B, T_loc, Dr]}``.  Returns
    (y [B, 1, d], cache), updated in place.  Three all-reduces over
    `axis`: the max and the normaliser [B, H, 1, 1] and the latent output
    [B, 1, H, C], all f32."""
    B = x.shape[0]
    posv = torch.full((B, 1), int(pos), dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, posv, cfg.rope_theta)
    ckv_new, k_rope_new = _mla_kv_latent(p, x, cfg, posv)
    t_loc, start = _shard(cache, mesh, axis)
    _owner_write(cache["ckv"], ckv_new, pos, start)
    _owner_write(cache["k_rope"], k_rope_new, pos, start)
    group = mesh.get_group(axis)
    q_c, w_v = mla_absorb_q(p, cfg, q_nope)
    cf = cache["ckv"].float()
    sc = (torch.einsum("bshc,btc->bhst", q_c, cf)
          + torch.einsum("bshd,btd->bhst", q_rope.float(),
                         cache["k_rope"].float())) * _mla_scale(cfg)
    valid = (start + torch.arange(t_loc, device=x.device)) <= pos
    pexp, denom = _softmax_parts(sc, valid, group, ledger)
    o_c = all_reduce(torch.einsum("bhst,btc->bshc", pexp, cf),
                     dist.ReduceOp.SUM, group, ledger)
    o_c = o_c / denom.movedim(-1, 1)
    return mla_absorb_out(p, x, cfg, o_c, w_v), cache


def reckon_seqshard_decode(cfg, batch: int, n_steps: int = 1) -> dict:
    """The collectives of `n_steps` seq-sharded decode steps on one rank
    decoding `batch` rows: per attention layer and step, three f32
    all-reduces — the max and the normaliser [B, H] and the numerator
    [B, H, D] (MLA: [B, H, C]).  The ledger's keys and kind names."""
    from repro_torch.models.model import mixer_kind
    n_attn = sum(mixer_kind(cfg, i) == "attn" for i in range(cfg.n_layers))
    width = cfg.kv_lora_rank if cfg.attn == "mla" else cfg.head_dim
    per = (2 + width) * int(batch) * cfg.n_heads * 4
    n = n_attn * int(n_steps)
    return {"collective_ops": {"all-reduce": 3 * n},
            "collective_bytes": {"all-reduce": per * n}}


def seqshard_caches(caches, mesh, *, axis: str = "model", batch_axes=None):
    """This rank's caches for ``decode_step(attn_impl="seqshard")``, cut
    from full per-layer `caches` (new tensors): every leaf's rows split
    over `batch_axes` (None: all rows), and each attention layer's ``kv``
    leaves also split on the sequence dim over `axis`.  An SSM state and
    an encoder-decoder's cross K/V are whole on every rank of `axis`."""
    def walk(node, in_kv):
        if isinstance(node, dict):
            return {k: walk(v, in_kv or k == "kv") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_kv) for v in node)
        return shard_local(node, Spec(batch_axes or None,
                                      axis if in_kv else None), mesh)
    return walk(caches, False)
