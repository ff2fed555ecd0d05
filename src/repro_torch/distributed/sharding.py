"""Per-architecture sharding rules (DP/TP/EP; divisibility-checked), the
JAX package's ``distributed/sharding.py`` for the port's trees.

A rule walks the parameter tree with structural context (a dict holding a
``router`` leaf is a MoE FFN) and gives each weight one axis over
``model``:

* TP: linear layers shard their output feature dim over ``model``; their
  consumers (``wo``, ``w_down``, ``w_out``) shard the input dim, so each
  attention/FFN block is a Megatron pair (one all-reduce per block).
* EP: routed expert stacks [E, d, f] shard E over ``model`` when it
  divides; otherwise TP inside the expert.
* Embedding: vocab over ``model`` when divisible, else d_model, else
  replicated.
* 1-D scales/biases and routers are replicated.

A spec is a :class:`Spec`, one entry per tensor dim: None, a mesh-axis
name, or a tuple of names (major to minor).  The port keeps a per-layer
list where the JAX package stacks layers, so a layer's leaf here has no
leading ``[m]`` dim and the batch dim of every cache leaf is 0.  The rules
use axes counted from the end and give the JAX package's answer with the
stacked dim dropped, except where the stacked dim changes it: the JAX
package's MoE rule takes any ``w_gate``/``w_up``/``w_down`` of rank >= 3
inside a MoE FFN for an expert stack, so a stacked shared expert
``[m, d, f]`` shards its LAYER axis over ``model`` when ``m`` and the
expert count both divide the model axis; the port's shared expert is
``[d, f]`` and takes the Megatron split of ``f``.

A mesh is anything with ``mesh_dim_names`` and ``shape`` (a
``torch.distributed.device_mesh.DeviceMesh``); :func:`shard_local` also
reads the calling rank's coordinate from it.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

# leaf name -> axis (negative, from the end) to shard over `model`
_OUT_DIM = {"wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b",
            "w_gate", "w_up", "w_z", "w_x", "w_B", "w_C", "w_dt"}
_IN_DIM = {"wo", "w_down", "w_out"}
_REPLICATED = {"router", "scale", "bias", "A_log", "D", "dt_bias",
               "gate_norm", "q_norm", "k_norm", "kv_norm", "conv_w", "conv_b",
               "pos"}


class Spec(tuple):
    """A partition spec: entry i says how tensor dim i is split — None
    (replicated), a mesh-axis name, or a tuple of names, major to minor.
    Dims past the last entry are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _spec2(shape, model_ax: Optional[int], model: str, msize: int,
           data_ax: Optional[int] = None, data: str = "data", dsize: int = 1
           ) -> Spec:
    """`model` on one axis and (FSDP) `data` on another; axes are negative
    (from the end), each placement divisibility-checked on its own."""
    spec = [None] * len(shape)
    if model_ax is not None:
        ax = len(shape) + model_ax
        if 0 <= ax and shape[ax] > 0 and shape[ax] % msize == 0:
            spec[ax] = model
    if data_ax is not None and dsize > 1:
        ax = len(shape) + data_ax
        if (0 <= ax and spec[ax] is None and shape[ax] > 0
                and shape[ax] % dsize == 0):
            spec[ax] = data
    return Spec(*spec)


def _leaf_spec(name: str, shape, *, in_moe: bool, ep_ok: bool, model: str,
               size: int, fsdp: bool = False, dsize: int = 1) -> Spec:
    if name in _REPLICATED or len(shape) <= 1:
        return Spec()
    if name == "tok":                       # embedding [V, d]
        if shape[0] % size == 0:
            return _spec2(shape, -2, model, size,
                          -1 if fsdp else None, dsize=dsize)
        if shape[1] % size == 0:
            return Spec(None, model)
        return Spec()
    if name == "w":                         # lm head [d, V]
        if shape[-1] % size == 0:
            return _spec2(shape, -1, model, size,
                          -2 if fsdp else None, dsize=dsize)
        return _spec2(shape, -2, model, size)
    if in_moe and name in ("w_gate", "w_up", "w_down") and len(shape) >= 3:
        if ep_ok and shape[-3] % size == 0:           # EP over experts
            # FSDP: the expert's ffn width over data as well
            d_ax = (-2 if name == "w_down" else -1) if fsdp else None
            return _spec2(shape, -3, model, size, d_ax, dsize=dsize)
        if name == "w_down":
            return _spec2(shape, -2, model, size,
                          -1 if fsdp else None, dsize=dsize)
        return _spec2(shape, -1, model, size,
                      -2 if fsdp else None, dsize=dsize)
    if name in _OUT_DIM:
        return _spec2(shape, -1, model, size,
                      -2 if fsdp else None, dsize=dsize)
    if name in _IN_DIM:
        return _spec2(shape, -2, model, size,
                      -1 if fsdp else None, dsize=dsize)
    return Spec()


def ep_ok(n_experts: int, n_devices: int) -> bool:
    """Whether the expert dim divides the mesh: the EP rule's test."""
    return n_devices > 0 and n_experts % n_devices == 0


def _check_ep(n_experts: int, n_devices: int):
    if not ep_ok(n_experts, n_devices):
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{n_devices} devices")


def ep_owner(expert: int, n_experts: int, n_devices: int) -> int:
    """Owner device of `expert` under EP: the expert dim splits into
    contiguous blocks, so device d owns experts [d·E/n, (d+1)·E/n)."""
    _check_ep(n_experts, n_devices)
    return int(expert) // (n_experts // n_devices)


def ep_partition(n_experts: int, n_devices: int):
    """Per-device expert-id ranges under the contiguous-block EP rule."""
    _check_ep(n_experts, n_devices)
    blk = n_experts // n_devices
    return [range(d * blk, (d + 1) * blk) for d in range(n_devices)]


def needs_fsdp(cfg, model_size: int, *, train: bool,
               hbm_budget: float = 12e9) -> bool:
    """Auto policy: 2-D shard (FSDP over `data`) when the 1-D TP state
    would not fit.  State bytes per param: bf16 weights (+ f32 moments
    when training)."""
    per_param = 10.0 if train else 2.0
    total = cfg.param_counts()["total"]
    return total * per_param / max(1, model_size) > hbm_budget


def param_pspecs(params: Any, cfg, *, model_axis: str = "model",
                 model_size: int = 16, fsdp: bool = False,
                 data_size: int = 1) -> Any:
    """Tree of :class:`Spec` matching `params` (anything with ``.shape``
    at the leaves)."""
    ep = (cfg.moe_mode != "tp") and cfg.is_moe \
        and cfg.n_experts % model_size == 0

    def build(node, in_moe, name=""):
        if isinstance(node, dict):
            is_moe_ffn = "router" in node
            return {k: build(v, in_moe or is_moe_ffn, k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, in_moe, name) for v in node)
        if node is None:
            return None
        return _leaf_spec(name, tuple(node.shape), in_moe=in_moe, ep_ok=ep,
                          model=model_axis, size=model_size, fsdp=fsdp,
                          dsize=data_size)

    return build(params, False)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of `mesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's index, count) over the mesh axes `axes` (a name or a
    tuple of names, major to minor; None or () is one position)."""
    if axes is None:
        axes = ()
    elif isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
        n *= sizes[a]
    return idx, n


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: ``Shard(dim)`` for each mesh
    axis that splits tensor dim `dim`, ``Replicate()`` for the others.  A
    dim split over several axes must name them in the mesh's order (which
    is DTensor's nesting order)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    dim_of = {}
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: axes {axes} out of the mesh's order "
                             f"{tuple(names)}")
        for a in axes:
            dim_of[a] = dim
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


class NamedSharding(NamedTuple):
    """A spec on a mesh: where each leaf of a restored tree goes."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def param_shardings(params, cfg, mesh, *, train: bool = False,
                    fsdp: Optional[bool] = None, **kw):
    """Tree of :class:`NamedSharding` for `params` on `mesh`; FSDP by
    :func:`needs_fsdp` unless given."""
    sizes = axis_sizes(mesh)
    size = sizes.get("model", 1)
    dsize = sizes.get("data", 1)
    if fsdp is None:
        fsdp = needs_fsdp(cfg, size, train=train)
    specs = param_pspecs(params, cfg, model_size=size, fsdp=fsdp,
                         data_size=dsize, **kw)

    def wrap(node):
        if isinstance(node, Spec):
            return NamedSharding(mesh, node)
        if isinstance(node, dict):
            return {k: wrap(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(wrap(v) for v in node)
        return None
    return wrap(specs)


def shard_local(tensor: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of `tensor` under `spec` on `mesh`, as a new
    contiguous tensor: each split dim cut into equal contiguous blocks,
    the block index counted over the dim's axes major to minor (the
    layout of ``Shard`` placements and of the JAX package's
    ``NamedSharding``)."""
    out = tensor
    for dim, entry in enumerate(spec):
        if entry is None or entry == ():
            continue
        idx, n = axis_index(mesh, entry)
        if tensor.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split {n} ways ({spec})")
        blk = tensor.shape[dim] // n
        out = out.narrow(dim, idx * blk, blk)
    return out.clone(memory_format=torch.contiguous_format)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes used for batch DP: ('pod', 'data') on the multi-pod mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= sizes[a]
    return n


def _dp_entry(mesh):
    dp = data_axes(mesh)
    return dp if dp else None


def batch_pspecs(batch_spec: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """Input specs: batch dim over the DP axes (mrope positions: dim 1)."""
    dp = _dp_entry(mesh)
    dps = _dp_size(mesh)
    out = {}
    for name, (shape, _) in batch_spec.items():
        if name == "mrope_positions":            # [3, B, S]
            out[name] = (Spec(None, dp, None) if shape[1] % dps == 0
                         else Spec())
        elif shape[0] % dps == 0:
            out[name] = Spec(dp, *([None] * (len(shape) - 1)))
        else:
            out[name] = Spec(*([None] * len(shape)))
    return out


def cache_pspecs(caches, mesh, cfg, *, seq_shard: bool = False):
    """Specs of the per-layer caches: batch (dim 0 of every leaf) over the
    DP axes when divisible, and the trailing feature dim over ``model``
    when divisible.  GQA k/v [B,T,H,D]: B over dp, D over model; MLA ckv
    [B,T,C]: C over model; SSM state: B and its last dim.

    ``seq_shard=True``: KV leaves split the SEQUENCE dim over ``model``
    instead of the feature dim — the layout of
    ``models/decode_attention.py``."""
    dp = _dp_entry(mesh)
    msize = axis_sizes(mesh).get("model", 1)
    dpsize = _dp_size(mesh)

    def leaf(x, in_kv):
        shape = tuple(x.shape)
        spec = [None] * len(shape)
        if shape and shape[0] % dpsize == 0 and shape[0] >= dpsize:
            spec[0] = dp
        if in_kv and seq_shard:
            if shape[1] % msize == 0:
                spec[1] = "model"
        elif len(shape) >= 2 and shape[-1] % msize == 0:
            spec[-1] = "model"
        return Spec(*spec)

    def walk(node, in_kv=False):
        if isinstance(node, dict):
            return {k: walk(v, in_kv or k == "kv") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_kv) for v in node)
        if node is None:
            return None
        return leaf(node, in_kv)

    return walk(caches)
