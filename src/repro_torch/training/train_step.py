"""The train step: loss, gradients and AdamW, eager PyTorch — the JAX
package's ``training/train_step.py`` without ``jax.jit`` (and without its
``unroll``: the port's layers are already a list).

Options:

* ``remat`` — each super-block of the stack recomputes its activations in
  the backward pass (``models.model.forward(remat=True)``);
* ``grad_compress`` — int8 error-feedback compression of every gradient
  before the update: ``g + residual`` is quantised per tensor with an f32
  scale ``max|g + residual| / 127``, and the quantisation error is carried
  in the state and added back at the next step.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.models.layers import dtype_of
from repro_torch.models.model import train_loss
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update, cosine_lr,
                                            tree_leaves, tree_map)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    err: Optional[Any]            # error-feedback residuals (grad compress)


def init_train_state(params, *, grad_compress: bool = False) -> TrainState:
    """The state of step 0 around `params` (on their device: the port's
    ``init_params`` put them on the card unless asked for the CPU)."""
    err = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params) \
        if grad_compress else None
    return TrainState(params, adamw_init(params), err)


def _compress_ef(g, e):
    """int8-quantise ``g + e``; returns (dequantised, new residual).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gf = g.float() + e
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, gf - deq


def as_tensors(batch: Dict[str, np.ndarray], cfg, device
               ) -> Dict[str, torch.Tensor]:
    """A numpy batch (``training.data.data_iter``) on `device`: integer
    arrays keep their dtype, float ones (input embeddings) take the
    model's dtype (the JAX package would run the whole pass in f32)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.is_floating_point():
            t = t.to(dtype_of(cfg))
        out[k] = t.to(device)
    return out


def loss_and_grads(params, cfg, batch, *, remat=True, moe_impl="einsum",
                   aux_weight=0.01):
    """(loss, {"nll", "aux"}, grads) of ``models.model.train_loss`` at
    `params`; grads has the structure of `params`, each leaf in its
    parameter's dtype (zeros for a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    it = iter(live)
    loss, metrics = train_loss(tree_map(lambda _: next(it), params), cfg,
                               batch, remat=remat, moe_impl=moe_impl,
                               aux_weight=aux_weight)
    flat = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, flat)])
    grads = tree_map(lambda _: next(it), params)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg, *, lr=3e-4, warmup=100, total_steps=10000,
                    remat=True, moe_impl="einsum", grad_compress=False,
                    aux_weight=0.01):
    """Returns ``train_step(state, batch) -> (state, metrics)``, `batch` a
    dict of tensors on the parameters' device; metrics are 0-d tensors
    ``loss``, ``nll``, ``aux``, ``gnorm`` and ``lr``.  The step updates the
    parameters, moments and residuals of `state` in place (see
    ``adamw_update``) and returns it."""

    def train_step(state: TrainState, batch) -> tuple:
        loss, metrics, grads = loss_and_grads(
            state.params, cfg, batch, remat=remat, moe_impl=moe_impl,
            aux_weight=aux_weight)
        if grad_compress:
            def compress(g, e):
                deq, res = _compress_ef(g, e)
                e.copy_(res)
                return deq
            grads = tree_map(compress, grads, state.err)
        step_lr = cosine_lr(state.opt.step, peak=lr, warmup=warmup,
                            total=total_steps)
        _, _, gnorm = adamw_update(grads, state.opt, state.params,
                                   lr=step_lr)
        return state, {"loss": loss, "nll": metrics["nll"],
                       "aux": metrics["aux"], "gnorm": gnorm, "lr": step_lr}

    return train_step
