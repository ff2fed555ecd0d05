"""Model facade: init / init_cache / forward / prefill / decode_step.
Every decoder layer is ``x += mixer(norm(x)); x += ffn(norm(x))`` with
mixer ∈ {GQA or MLA attention, Mamba2} and ffn ∈ {MoE, dense MLP, none}:
dense and MoE decoders, the SSM family (mamba2, every layer a Mamba2 mixer
with no FFN) and the hybrid family (jamba's attention every ``attn_every``
layers, Mamba2 elsewhere).  An encoder-decoder (switch-large-128,
whisper-small) runs a dense, non-causal encoder over input embeddings
first, and each decoder layer adds ``x += cross_attn(norm_x(x))`` over the
encoder's K/V between its mixer and its FFN; its positions are a learned
table added to the inputs.  An M-RoPE model (qwen2-vl-2b) takes input
embeddings and three position channels instead of tokens.

Parameters are a plain dict with a **per-layer list**, not the JAX
package's scanned stack::

    {"embed": {["tok": [V, d]], ["pos": [P, d]]},
     ["encoder": [{"norm1", "attn", "norm2", "ffn"}, ...], "enc_norm",]
     "layers": [{"norm1", "attn" | "mamba", ["norm_x", "xattn"],
                 ["norm2", "ffn"]}, ...],
     "final_norm": {"scale"}, ["lm_head": {"w": [d, V]}]}

(no ``lm_head`` with ``tie_embeddings``: the head is ``embed.tok.T``)

and the caches a per-layer list of ``{"kv": ...}`` (attention) or
``{"ssm": {"state", "conv"}}`` (Mamba2), an encoder-decoder's with the
cross-attention's ``"xkv": {"k", "v"}`` [B, enc_seq_len, H, D] beside.
``init_params`` draws the parameters from a seeded ``torch.Generator`` (on
the target device);
``repro_torch.convert.params_from_jax`` builds the same structure from the
JAX package's parameter tree.  :func:`prefill` followed by
:func:`decode_step` is the fully resident model that the serving paths
are checked against; :func:`train_loss` is the training objective, with
every super-block of the stack rematerialised under ``remat``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import axis_index
from repro_torch.models import attention as attn_lib
from repro_torch.models import decode_attention as da
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (apply_mlp, apply_norm, dtype_of,
                                       init_embed, init_lm_head, init_mlp,
                                       init_norm)


def stack_layout(cfg):
    """(prefix_indices, period, n_superblocks) of the JAX package's scanned
    stack — what the converter needs to unstack its parameters."""
    prefix = list(range(cfg.first_dense))
    period = 1
    if cfg.is_moe and cfg.moe_every > 1:
        period = period * cfg.moe_every // math.gcd(period, cfg.moe_every)
    if cfg.family == "hybrid":
        period = period * cfg.attn_every // math.gcd(period, cfg.attn_every)
    rest = cfg.n_layers - cfg.first_dense
    assert rest % period == 0, (cfg.name, rest, period)
    return prefix, period, rest // period


def mixer_kind(cfg, idx: int) -> str:
    """``"mamba"`` or ``"attn"``: layer `idx`'s sequence mixer."""
    if cfg.family == "ssm" or (cfg.family == "hybrid"
                               and not cfg.attn_layer(idx)):
        return "mamba"
    return "attn"


def ffn_kind(cfg, idx: int) -> str:
    """``"moe"``, ``"mlp"`` or ``"none"`` (mamba2: no FFN at all)."""
    if cfg.moe_layer(idx):
        return "moe"
    return "mlp" if cfg.d_ff else "none"


def enc_config(cfg):
    """An encoder-decoder's encoder stack: dense, ``n_enc_layers`` deep."""
    return dataclasses.replace(cfg, n_layers=cfg.n_enc_layers, first_dense=0,
                               n_experts=0, top_k=0, n_shared_experts=0)


def _model_refusal(cfg) -> Optional[str]:
    fam, attn = cfg.family, cfg.attn
    if cfg.tie_embeddings and not cfg.embed_inputs:
        return "tied embeddings need a token embedding to tie to"
    if fam == "ssm":           # no attention layer at all
        ok = attn == "none" and cfg.pos == "none" and cfg.embed_inputs \
            and not (cfg.encoder_decoder or cfg.mrope)
    elif cfg.encoder_decoder:
        # switch-large-128 and whisper-small: GQA decoders over a dense
        # encoder, learned positions, token inputs to the decoder
        ok = fam != "hybrid" and attn == "gqa" \
            and cfg.pos == "learned" and cfg.embed_inputs \
            and not cfg.mrope and cfg.n_enc_layers > 0 \
            and cfg.enc_seq_len > 0
    else:
        ok = attn in ("gqa", "mla") and (
            cfg.pos == "rope" or (fam == "hybrid" and cfg.pos == "none"))
        if cfg.mrope:          # qwen2-vl-2b: rotates GQA heads only
            ok = ok and attn == "gqa" and cfg.pos == "rope" \
                and fam != "hybrid"
        # input embeddings come with M-RoPE positions (qwen2-vl-2b)
        ok = ok and (cfg.embed_inputs or cfg.mrope)
    if fam in ("ssm", "hybrid"):
        # a Mamba2 mixer needs a state, whole heads and whole groups
        ok = ok and cfg.ssm_state > 0 and cfg.ssm_headdim > 0 \
            and cfg.ssm_conv > 1 and cfg.d_inner % cfg.ssm_headdim == 0 \
            and cfg.ssm_groups > 0 and cfg.ssm_heads % cfg.ssm_groups == 0 \
            and (fam == "ssm" or cfg.attn_every > 0)
    if not ok:
        return ("the port serves dense and MoE GQA/MLA RoPE decoders, "
                "M-RoPE GQA decoders over input embeddings, encoder-decoders "
                "of GQA layers with learned positions, Mamba2 SSMs and "
                "attention/Mamba2 hybrids")
    return None


def refusal(cfg, entry: str = "model") -> Optional[str]:
    """Why `entry` does not take `cfg`, or None.  The one place that says
    which entry point takes which config:

    * ``"model"``: the resident model (``init_params``, ``init_cache``,
      ``forward``/``prefill``/``decode_step``), the converter and the
      store — every family above;
    * ``"zipserver"``: ``ZipServer`` and its ``decode_step`` — not a config
      fed input embeddings or M-RoPE positions;
    * ``"rows"``: continuous batching and the front end
      (``ZipServer.decode_rows``, ``KVPagePool``, ``BatchServer`` and the
      CLI) — neither those nor an encoder-decoder.

    The JAX package has no correct path for what the last two refuse: its
    ``ZipServer`` embeds tokens only (an embeddings-input config has no
    ``embed.tok``) and rotates by the plain position, its ``decode_rows``
    drops the cross-attention, and its ``BatchServer`` and CLI prefill
    token prompts with no encoder inputs."""
    assert entry in ("model", "zipserver", "rows"), entry
    why = _model_refusal(cfg)
    if why is None and entry != "model" and (cfg.mrope
                                             or not cfg.embed_inputs):
        why = ("input embeddings and M-RoPE positions are served by the "
               "resident model only: the JAX package's ZipServer, "
               "BatchServer and CLI embed tokens and rotate by the plain "
               "position, so there is no reference path to serve them")
    if why is None and entry == "rows" and cfg.encoder_decoder:
        why = ("an encoder-decoder is served by the resident model and "
               "ZipServer.decode_step only: the JAX package's decode_rows "
               "drops the cross-attention and its BatchServer and CLI take "
               "no encoder inputs, so there is no reference path to serve "
               "it")
    return None if why is None else f"{cfg.name}: {why}"


def check_supported(cfg, entry: str = "model"):
    """Raise ``NotImplementedError`` for a config `entry` does not take
    (see :func:`refusal`): every entry point that takes a config calls
    this before any work."""
    why = refusal(cfg, entry)
    if why is not None:
        raise NotImplementedError(why)


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_layer(gen, cfg, idx: int, device, cross: bool = False
               ) -> Dict[str, Any]:
    """Layer `idx`'s weights; ``cross=True`` adds an encoder-decoder's
    ``norm_x`` and cross-attention ``xattn``."""
    p: Dict[str, Any] = {"norm1": init_norm(cfg, device)}
    if mixer_kind(cfg, idx) == "attn":
        p["attn"] = attn_lib.init_attn(gen, cfg, device)
    else:
        p["mamba"] = mamba_lib.init_mamba(gen, cfg, device)
    fk = ffn_kind(cfg, idx)
    if fk != "none":
        p["norm2"] = init_norm(cfg, device)
        p["ffn"] = (moe_lib.init_moe(gen, cfg, device) if fk == "moe"
                    else init_mlp(gen, cfg, device))
    if cross:
        p["norm_x"] = init_norm(cfg, device)
        p["xattn"] = attn_lib.init_attn(gen, cfg, device, cross=True)
    return p


def init_params(cfg, seed: int = 0, device=None) -> Dict[str, Any]:
    """Seeded random parameters on `device` (the card by default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return build_params(gen, cfg, dev)


def build_params(gen, cfg, dev) -> Dict[str, Any]:
    """The parameter tree drawn from `gen` on `dev`, with no check of the
    config or the device: :func:`init_params` on its device; a tree of
    shapes on the ``meta`` device (with a CPU generator)."""
    p: Dict[str, Any] = {"embed": init_embed(gen, cfg, dev)}
    if cfg.encoder_decoder:
        ecfg = enc_config(cfg)
        p["encoder"] = [init_layer(gen, ecfg, i, dev)
                        for i in range(ecfg.n_layers)]
        p["enc_norm"] = init_norm(cfg, dev)
    p["layers"] = [init_layer(gen, cfg, i, dev, cross=cfg.encoder_decoder)
                   for i in range(cfg.n_layers)]
    p["final_norm"] = init_norm(cfg, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(gen, cfg, dev)
    return p


def lm_head_weight(p, cfg):
    """[d, V]: ``lm_head.w``, or ``embed.tok.T`` with tied embeddings."""
    return p["embed"]["tok"].T if cfg.tie_embeddings else p["lm_head"]["w"]


def init_layer_cache(cfg, idx: int, batch: int, length: int, device
                     ) -> Dict[str, Any]:
    """Layer `idx`'s empty cache: ``{"kv": ...}`` of `length` tokens, or a
    Mamba2 layer's sequence-free ``{"ssm": {"state", "conv"}}``; an
    encoder-decoder's also ``{"xkv": {"k", "v"}}`` [B, enc_seq_len, H, D]."""
    c: Dict[str, Any] = {}
    if mixer_kind(cfg, idx) == "attn":
        c["kv"] = attn_lib.init_kv_cache(cfg, batch, length, device)
    else:
        c["ssm"] = mamba_lib.init_ssm_cache(cfg, batch, device)
    if cfg.encoder_decoder:
        shape = (batch, cfg.enc_seq_len, cfg.n_heads, cfg.head_dim)
        c["xkv"] = {name: torch.zeros(shape, dtype=dtype_of(cfg),
                                      device=device) for name in ("k", "v")}
    return c


def init_cache(cfg, batch: int, length: int, device=None) -> List[Dict]:
    """Per-layer caches on `device` (the card by default)."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [init_layer_cache(cfg, i, batch, length, dev)
            for i in range(cfg.n_layers)]


# ----------------------------------------------------------------------------
# inputs and the encoder
# ----------------------------------------------------------------------------
def _decoder_inputs(p, cfg, tokens, embeds):
    """[B, S, d] decoder inputs: the embedded tokens, or `embeds` for a
    config fed embeddings; learned positions from 0 added."""
    x = p["embed"]["tok"][tokens] if cfg.embed_inputs else embeds
    if cfg.pos == "learned":
        x = x + p["embed"]["pos"][:x.shape[1]][None]
    return x


def decode_inputs(p, cfg, tokens, pos: int, embeds=None):
    """[B, 1, d] input of one decode step at position `pos`: the learned
    position is the table's row ``min(pos, rows - 1)``."""
    x = p["embed"]["tok"][tokens] if cfg.embed_inputs else embeds
    if cfg.pos == "learned":
        table = p["embed"]["pos"]
        x = x + table[min(int(pos), table.shape[0] - 1)][None, None]
    return x


def encode(p, cfg, enc_embeds):
    """An encoder-decoder's encoder: enc_embeds [B, Se, d] plus learned
    positions through the dense, non-causal stack, then ``enc_norm``."""
    ecfg = enc_config(cfg)
    x = enc_embeds + p["embed"]["pos"][:enc_embeds.shape[1]][None]
    B, Se = x.shape[:2]
    positions = torch.arange(Se, dtype=torch.int32,
                             device=x.device)[None].expand(B, Se)
    for lp in p["encoder"]:
        h = apply_norm(lp["norm1"], x, ecfg)
        x = x + attn_lib.gqa_forward(lp["attn"], h, ecfg, positions,
                                     causal=False)
        x = x + apply_mlp(lp["ffn"], apply_norm(lp["norm2"], x, ecfg), ecfg)
    return apply_norm(p["enc_norm"], x, cfg)


def apply_cross(lp, x, cfg, xkv):
    """A decoder layer's cross-attention step, ``x + cross_attn(norm_x(x))``
    over the encoder's K/V (`xkv`)."""
    hx = apply_norm(lp["norm_x"], x, cfg)
    return x + attn_lib.cross_attn(lp["xattn"], hx, cfg, xkv)


# ----------------------------------------------------------------------------
# full-sequence passes
# ----------------------------------------------------------------------------
def _layer_full(lp, x, cfg, positions, mrope, enc_out, moe_impl,
                want_cache: bool):
    """One decoder layer over a whole sequence.  Returns (x, cache or
    None, aux or None, router top-k ids or None)."""
    h = apply_norm(lp["norm1"], x, cfg)
    if "mamba" in lp:
        y, c = mamba_lib.mamba_forward(lp["mamba"], h, cfg,
                                       return_cache=True)
        c = {"ssm": c}
    elif cfg.attn == "mla":
        y, kv = attn_lib.mla_forward(lp["attn"], h, cfg, positions,
                                     return_cache=True)
        c = {"kv": kv}
    else:
        y, kv = attn_lib.gqa_forward(lp["attn"], h, cfg, positions,
                                     mrope_positions=mrope,
                                     return_cache=True)
        c = {"kv": kv}
    x = x + y
    if "xattn" in lp:
        c["xkv"] = attn_lib.cross_attn_cache(lp["xattn"], enc_out, cfg)
        x = apply_cross(lp, x, cfg, c["xkv"])
    aux = top_i = None
    if "ffn" in lp:
        h2 = apply_norm(lp["norm2"], x, cfg)
        if "router" in lp["ffn"]:
            y2, (top_i, probs) = moe_lib.apply_moe(lp["ffn"], h2, cfg,
                                                   impl=moe_impl)
            # a sigmoid router (noaux_tc) balances by its bias: no aux loss
            aux = (moe_lib.load_balance_loss(probs, top_i, cfg)
                   if cfg.router_scoring == "softmax"
                   else torch.zeros((), dtype=torch.float32,
                                    device=x.device))
        else:
            y2 = apply_mlp(lp["ffn"], h2, cfg)
        x = x + y2
    return x, (c if want_cache else None), aux, top_i


def _superblock(layers, x, aux, cfg, positions, mrope, enc_out, moe_impl):
    """`layers` in order over a whole sequence, no caches: (x, aux) with
    each MoE layer's load-balance loss added to `aux`."""
    for lp in layers:
        x, _, a, _ = _layer_full(lp, x, cfg, positions, mrope, enc_out,
                                 moe_impl, False)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(p, cfg, tokens=None, *, mode="full", moe_impl="einsum",
            router_ids=None, embeds=None, enc_embeds=None,
            mrope_positions=None, remat=False):
    """Full-sequence causal pass.  tokens: [B, S] int, or ``embeds`` [B, S,
    d] for a config fed embeddings; ``enc_embeds`` [B, Se, d]: an
    encoder-decoder's encoder inputs; ``mrope_positions`` [3, B, S]: an
    M-RoPE config's position channels (without them it rotates by the
    sequence index).  Returns (logits [B, S, V], caches, aux): with
    ``mode="prefill"`` the per-layer list of caches (attention: ``{"kv":
    {"k", "v"}}`` of length S, with MLA the latent ``{"ckv", "k_rope"}``;
    Mamba2: ``{"ssm": {"state", "conv"}}`` after the last token; an
    encoder-decoder's with ``"xkv"``), else None; aux is the summed
    load-balance loss of the MoE layers.  A Mamba2 stack needs S to be a
    multiple of ``min(ssm_chunk, S)``.  When `router_ids` is a list, the
    router's [B, S, k] expert ids of each MoE layer are appended to it.

    ``remat=True`` (``mode="full"`` only) runs each super-block of
    ``period`` layers after the ``first_dense`` prefix under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward pass instead of kept, as the JAX package's scan body runs
    under ``jax.checkpoint``.  The prefix layers are not rematerialised;
    the values are the same either way."""
    assert mode in ("full", "prefill"), mode
    if remat and (mode != "full" or router_ids is not None):
        raise ValueError("remat runs a full pass that records nothing")
    if cfg.encoder_decoder and enc_embeds is None:
        raise ValueError(f"{cfg.name}: an encoder-decoder's full pass needs "
                         f"enc_embeds")
    enc_out = encode(p, cfg, enc_embeds) if cfg.encoder_decoder else None
    x = _decoder_inputs(p, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    mrope = mrope_positions if cfg.mrope else None
    caches = [] if mode == "prefill" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = p["layers"]
    n_plain = cfg.first_dense if remat else len(layers)
    for lp in layers[:n_plain]:
        x, c, a, top_i = _layer_full(lp, x, cfg, positions, mrope, enc_out,
                                     moe_impl, caches is not None)
        if caches is not None:
            caches.append(c)
        if a is not None:
            aux = aux + a
            if router_ids is not None:
                router_ids.append(top_i)
    if remat:
        _, period, _ = stack_layout(cfg)
        for b in range(n_plain, len(layers), period):
            x, aux = checkpoint(_superblock, layers[b:b + period], x, aux,
                                cfg, positions, mrope, enc_out, moe_impl,
                                use_reentrant=False)
    x = apply_norm(p["final_norm"], x, cfg)
    return x @ lm_head_weight(p, cfg), caches, aux


def train_loss(p, cfg, batch, *, remat=True, moe_impl="einsum",
               aux_weight=0.01):
    """The training objective on a batch dict of ``batch_spec(cfg, shape,
    "train")``'s keys (``tokens`` or ``embeds``, ``labels``, and
    ``enc_embeds`` / ``mrope_positions`` where the config takes them):
    the mean next-token NLL over labels >= 0, from f32 log-softmax, plus
    ``aux_weight`` times the summed load-balance loss.  Returns (loss,
    {"nll", "aux"})."""
    logits, _, aux = forward(
        p, cfg, batch.get("tokens"), mode="full", moe_impl=moe_impl,
        embeds=batch.get("embeds"), enc_embeds=batch.get("enc_embeds"),
        mrope_positions=batch.get("mrope_positions"), remat=remat)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels.clamp(min=0)[..., None],
                                dim=-1)[..., 0]
    mask = (labels >= 0).float()
    loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return loss + aux_weight * aux, {"nll": loss, "aux": aux}


def prefill(p, cfg, tokens=None, *, moe_impl="einsum", router_ids=None,
            **inputs):
    """tokens: [B, S] (or the inputs :func:`forward` takes by keyword) ->
    (logits [B, S, V], per-layer caches of length S)."""
    logits, caches, _ = forward(p, cfg, tokens, mode="prefill",
                                moe_impl=moe_impl, router_ids=router_ids,
                                **inputs)
    return logits, caches


# ----------------------------------------------------------------------------
# decode
# ----------------------------------------------------------------------------
def decode_step(p, cfg, tokens, caches, pos: int, router_ids=None, *,
                embeds=None, mrope_positions=None, attn_impl="default",
                mesh=None, batch_axes=None, ledger=None):
    """One decode step.  tokens: [B, 1] int (None with ``embeds`` [B, 1, d]
    for a config fed embeddings); caches: per-layer list (updated in
    place; an encoder-decoder's cross-attention reads its ``xkv``); pos:
    index of the new token; mrope_positions: [3, B, 1] or None.  Returns
    (logits [B,1,V], caches).  When `router_ids` is a list, the router's
    [B,1,k] expert ids of each MoE layer are appended to it.

    ``attn_impl="seqshard"`` runs each attention layer as the
    sequence-sharded decode of ``models/decode_attention.py`` over the
    ``model`` axis of `mesh` (a ``DeviceMesh``), charging its collectives
    to `ledger` when given.  With `batch_axes` (mesh axis names) the
    batch splits over those axes: the inputs stay the whole batch, this
    rank decodes its B/dp rows and returns their logits.  `caches` are
    this rank's (``decode_attention.seqshard_caches``)."""
    if attn_impl not in ("default", "seqshard"):
        raise ValueError(f"attn_impl must be 'default' or 'seqshard', got "
                         f"{attn_impl!r}")
    seqshard = attn_impl == "seqshard"
    if seqshard:
        if mesh is None:
            raise ValueError("attn_impl='seqshard' needs a mesh")
        tokens, embeds, mrope_positions = _local_rows(
            mesh, batch_axes, tokens, embeds, mrope_positions)
    x = decode_inputs(p, cfg, tokens, pos, embeds)
    mrope = mrope_positions if cfg.mrope else None
    for lp, cache in zip(p["layers"], caches):
        h = apply_norm(lp["norm1"], x, cfg)
        if "mamba" in lp:
            y, _ = mamba_lib.mamba_decode(lp["mamba"], h, cfg, cache["ssm"])
        elif cfg.attn == "mla":
            y, _ = (da.mla_decode_seqsharded(lp["attn"], h, cfg, cache["kv"],
                                             pos, mesh, ledger=ledger)
                    if seqshard else
                    attn_lib.mla_decode(lp["attn"], h, cfg, cache["kv"], pos))
        elif seqshard:
            y, _ = da.gqa_decode_seqsharded(lp["attn"], h, cfg, cache["kv"],
                                            pos, mesh, mrope_positions=mrope,
                                            ledger=ledger)
        else:
            y, _ = attn_lib.gqa_decode(lp["attn"], h, cfg, cache["kv"], pos,
                                       mrope_positions=mrope)
        x = x + y
        if "xattn" in lp:
            x = apply_cross(lp, x, cfg, cache["xkv"])
        if "ffn" in lp:
            h2 = apply_norm(lp["norm2"], x, cfg)
            if "router" in lp["ffn"]:
                y2, ids = moe_lib.apply_moe_decode(lp["ffn"], h2, cfg)
                if router_ids is not None:
                    router_ids.append(ids)
            else:
                y2 = apply_mlp(lp["ffn"], h2, cfg)
            x = x + y2
    x = apply_norm(p["final_norm"], x, cfg)
    return x @ lm_head_weight(p, cfg), caches


def _local_rows(mesh, batch_axes, tokens, embeds, mrope_positions):
    """This rank's rows of the decode inputs when the batch splits over
    the mesh axes `batch_axes` (all rows when None)."""
    r, n = axis_index(mesh, batch_axes)
    B = (tokens if tokens is not None else embeds).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} ranks")
    rows = slice(r * (B // n), (r + 1) * (B // n))
    return (None if tokens is None else tokens[rows],
            None if embeds is None else embeds[rows],
            None if mrope_positions is None else mrope_positions[:, rows])
