"""The port's compressed store against the JAX package's, on the same
parameters (``repro_torch.convert.params_from_jax``):

* a store the JAX package built loads bit-exactly through the port;
* a store the port built is byte-for-byte the JAX package's (every group
  file and the manifest), and loads bit-exactly in the JAX package;
* the thread-pool build writes exactly what a serial build writes;
* one ``FaultPlan`` seed gives the same integrity errors in both packages.
"""
import filecmp
import os

import numpy as np
import pytest

from repro.core import faults as ref_faults
from repro.core.store import ExpertStore as RefStore
from repro.core.store import build_store as ref_build_store
from repro_torch.core import bitfield, faults
from repro_torch.core.store import ExpertStore, build_store
from test_torch_models import both_params


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    jcfg, jparams, cfg, params = both_params()
    ref_dir = str(tmp_path_factory.mktemp("ref_store"))
    ref_build_store(jparams, jcfg, ref_dir, k_shards=4)
    port_dir = str(tmp_path_factory.mktemp("port_store"))
    build_store(params, cfg, port_dir, k_shards=4, device="cpu", workers=4)
    return cfg, params, ref_dir, port_dir


def _ref_bits(arr) -> np.ndarray:
    return np.asarray(arr).view(np.uint16)


def test_reference_store_loads_bitexact_in_port(stores):
    cfg, params, ref_dir, _ = stores
    port, ref = ExpertStore(ref_dir), RefStore(ref_dir)
    assert sorted(port.groups) == sorted(ref.groups)
    for key, g in port.groups.items():
        for tidx, tm in enumerate(g.tensors):
            got = port.load_tensor(key, tidx)
            assert got.dtype == np.uint16 and got.shape == tuple(tm.shape)
            assert np.array_equal(got, _ref_bits(ref.load_tensor(key, tidx)))
    assert port.ratio() == ref.ratio() and port.rho() == ref.rho()
    port.close()
    ref.close()


def test_port_store_is_byte_identical(stores):
    _, params, ref_dir, port_dir = stores
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    match, mismatch, errors = filecmp.cmpfiles(ref_dir, port_dir, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    ref = RefStore(port_dir)
    for (l, e) in ref.groups:
        group = ref.load_group((l, e))
        for name, arr in group.items():
            want = bitfield.to_bits(params["layers"][l]["ffn"][name][e])
            assert np.array_equal(_ref_bits(arr), want)
    ref.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_parallel_build_matches_serial(stores, tmp_path, workers):
    cfg, params, _, port_dir = stores
    d = str(tmp_path / f"w{workers}")
    build_store(params, cfg, d, k_shards=4, device="cpu", workers=workers)
    names = sorted(os.listdir(port_dir))
    _, mismatch, errors = filecmp.cmpfiles(port_dir, d, names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("spec", ["bitflip:p=0.3;seed=11",
                                  "truncate:count=3;seed=4",
                                  "eio:p=0.2;seed=9"])
def test_fault_plan_same_integrity_errors(stores, spec):
    """Every chunk read under one seeded plan: the same chunks fail with
    the same reasons in both packages, and the same counters move."""
    _, _, ref_dir, _ = stores

    def outcomes(store_cls, plan, err_cls):
        st = store_cls(ref_dir, faults=plan, max_retries=1,
                       retry_backoff_s=0.0)
        out = []
        for key in sorted(st.groups):
            for tidx, tm in enumerate(st.groups[key].tensors):
                for what in ["sm"] + list(range(len(tm.e_sizes))):
                    try:
                        data = st.read_sm(key, tidx) if what == "sm" \
                            else st.read_e(key, tidx, what)
                        out.append((key, tidx, what, "ok", len(data)))
                    except err_cls as exc:
                        out.append((key, tidx, what, "fail", str(exc)))
        summary = st.fault_summary()
        st.close()
        return out, summary

    got = outcomes(ExpertStore, faults.FaultPlan.parse(spec),
                   faults.ChunkIntegrityError)
    want = outcomes(RefStore, ref_faults.FaultPlan.parse(spec),
                    ref_faults.ChunkIntegrityError)
    assert got == want
    assert any(o[3] == "fail" for o in got[0]) or \
        got[1]["read_retries"] > 0
