"""Sequence-sharded decode (``models/decode_attention.py`` through
``decode_step(attn_impl="seqshard", mesh=, batch_axes=("data",))``) on a
(2, 4) ("data", "model") mesh of 8 ``gloo`` processes on the CPU, against
the JAX package's DEFAULT jitted ``decode_step`` — its own seq-sharded run
fails on jamba under this JAX (``mamba_decode``'s reshape of a
batch-sharded operand), its default one is the oracle either way.

The four architectures of the reference's seq-sharded test (dense GQA,
qk-norm GQA, q-LoRA MLA with MoE, and the attention/Mamba2 hybrid), smoke
configs in f32, numpy-seeded parameters and caches, three steps whose
write positions fall in the first, an interior and the last of the four
16-position shards:

* each rank's logits (its data rank's 2 of 4 rows) within 1e-5 of the
  largest |logit| (the reference test's limit), and bit-equal across the
  four ranks of a model group;
* the shards gathered back equal the reference's cache after the steps:
  bit for bit outside the three written positions, within 1e-5 at them;
  a Mamba2 state (whole on every model rank) within 1e-5;
* each rank's ledger: three f32 all-reduces per attention layer and step,
  of the shapes the docstrings give.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.serving.kv_cache import unstack_layers as ref_unstack
from repro_torch.distributed.launch import spawn_ranks
from repro_torch.models.model import mixer_kind
from repro_torch.serving.kv_cache import map_tree

import _torch_ranks
from test_torch_models import both_params

ARCHS = ["granite-8b", "qwen3-14b", "deepseek-v2-236b", "jamba-v0.1-52b"]
DP, MP = 2, 4
B, T = 4, 64
POSITIONS = (5, 37, 63)          # shards of 16: first, interior, last
REL = 1e-5


def reference_run(arch):
    """(port config, port params, full per-layer caches, steps, reference
    logits per step, reference per-layer caches after the steps)."""
    n = ref_smoke_config(arch).n_layers
    jcfg, jparams, cfg, params = both_params(n_layers=n, arch=arch,
                                             dtype="float32")
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda: ref_init_cache(jcfg, B, T))
    jc = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.5
                                 ).astype(np.float32), shapes)
    caches = map_tree(lambda a: torch.from_numpy(np.array(a)),
                      ref_unstack(jc, jcfg))
    step = jax.jit(lambda p, b, c, pos: ref_decode_step(p, jcfg, b, c, pos))
    jcache = jax.tree.map(jnp.asarray, jc)
    steps, ref_logits = [], []
    for pos in POSITIONS:
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        lg, jcache = step(jparams, {"tokens": jnp.asarray(tok)}, jcache,
                          jnp.int32(pos))
        ref_logits.append(np.asarray(lg, np.float32))
        steps.append((pos, torch.from_numpy(tok)))
    final = ref_unstack(jax.tree.map(np.asarray, jcache), jcfg)
    return cfg, params, caches, steps, ref_logits, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    refs = [reference_run(arch) for arch in ARCHS]
    jobs = [(cfg, params, caches, steps)
            for cfg, params, caches, steps, _, _ in refs]
    outs = spawn_ranks(_torch_ranks.seqshard_rank, DP * MP, timeout_s=300,
                       args=(jobs, (DP, MP), ("data",)),
                       store_dir=str(tmp_path_factory.mktemp("store")))
    return refs, outs


def rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("a", range(len(ARCHS)), ids=ARCHS)
def test_seqshard_logits_match_reference(runs, a):
    refs, outs = runs
    ref_logits = refs[a][4]
    b = B // DP
    for r in range(DP * MP):
        d, mi = divmod(r, MP)
        logits = outs[r][a][0]
        for i, want in enumerate(ref_logits):
            assert logits[i].shape == (b, 1, want.shape[-1])
            assert rel(logits[i], want[d * b:(d + 1) * b]) <= REL, \
                (ARCHS[a], r, POSITIONS[i])
            # every rank of the model group holds the same combine
            assert np.array_equal(logits[i], outs[d * MP][a][0][i]), (r, i)


def gathered(outs, a, layer, group, name, kv):
    """Leaf `name` of `layer`'s cache, put together from every rank."""
    b = B // DP
    rows = []
    for d in range(DP):
        parts = [outs[d * MP + mi][a][1][layer][group][name]
                 for mi in range(MP)]
        if kv:
            rows.append(np.concatenate(parts, axis=1))
        else:
            for p in parts[1:]:      # whole on every rank of the group
                assert np.array_equal(p, parts[0]), (layer, name)
            rows.append(parts[0])
        assert rows[-1].shape[0] == b
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("a", range(len(ARCHS)), ids=ARCHS)
def test_seqshard_caches_match_reference(runs, a):
    refs, outs = runs
    cfg, final = refs[a][0], refs[a][5]
    written = np.zeros(T, bool)
    written[list(POSITIONS)] = True
    for layer, want_layer in enumerate(final):
        for group, leaves in want_layer.items():
            for name, want in leaves.items():
                got = gathered(outs, a, layer, group, name, group == "kv")
                assert got.shape == want.shape, (layer, name)
                if group == "kv":
                    assert np.array_equal(got[:, ~written],
                                          want[:, ~written]), (layer, name)
                    assert rel(got[:, written], want[:, written]) <= REL
                else:
                    assert rel(got, want) <= REL, (layer, group, name)


@pytest.mark.parametrize("a", range(len(ARCHS)), ids=ARCHS)
def test_seqshard_ledger(runs, a):
    refs, outs = runs
    cfg = refs[a][0]
    b = B // DP
    n_attn = sum(mixer_kind(cfg, i) == "attn" for i in range(cfg.n_layers))
    width = cfg.kv_lora_rank if cfg.attn == "mla" else cfg.head_dim
    per_layer = 2 * b * cfg.n_heads * 4 + b * cfg.n_heads * width * 4
    n_steps = len(POSITIONS)
    for r in range(DP * MP):
        summary = outs[r][a][2]
        assert summary["collective_ops"] == {"all-reduce": 3 * n_attn
                                             * n_steps}
        assert summary["collective_bytes"] == {
            "all-reduce": per_layer * n_attn * n_steps}
