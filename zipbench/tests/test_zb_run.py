"""The harness end to end on the CPU at tiny sizes: the result line, the
traced run, files found by name, the JAX check, the refusal without a
card."""
import json
import os
import subprocess
import sys

import pytest

from zipbench.tests.tiny import REPO, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
              "0123456789_.-")


@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12])
def test_tiny_cell_prints_contract_line(tiny_root, seed):
    rc, last, err = run_cell(tiny_root, "tiny-dsv2-resident", seed=seed)
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
    assert {"out_tok_s", "itl_p95_ms", "setup_s"} <= set(last["metrics"])
    for name, m in last["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0, name
    dev = last["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["count"] == 1
    assert err.strip().splitlines()[-2].startswith("check gap_max ")
    assert err.strip().splitlines()[-1] == "check failed 0 limit 0"


def test_traced_run_reports_per_layer(tiny_root):
    rc, last, err = run_cell(tiny_root, "tiny-dsv2-resident", seed=5,
                             trace=1)
    assert rc == 0, err[-3000:]
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(last["metrics"]) <= set(per_layer)
    assert {"blocked_ms", "server_self_ms", "step_mfu_pct"} <= \
        set(last["metrics"])
    assert 0 < last["metrics"]["step_mfu_pct"]["value"] < 100
    assert last["device"]["window_s"] > 0
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_work(tiny_root):
    """A seed fixes the sizes and tokens: two runs attempt requests drawn
    from one order (their counts differ only by host speed)."""
    from zipbench import traffic
    mix = traffic.load(tiny_root, "tiny.closed2")
    a, b = (traffic.Traffic(mix, 3, 512) for _ in range(2))
    c = traffic.Traffic(mix, 4, 512)
    assert all((a.request(i)[0] == b.request(i)[0]).all() for i in range(20))
    assert sorted(a.sizes(i) for i in range(64)) == \
        sorted(c.sizes(i) for i in range(64))


def test_pool_holds_the_mixs_quantiles():
    """The cell's pool is the stated distribution's quantiles: its medians
    are the mix's, every size lies within the clip, and every seed's first
    pool of requests is the whole pool."""
    import statistics
    from zipbench import traffic
    for w in BENCH["workloads"]:
        mix = traffic.load(REPO, w["traffic"])
        t = traffic.Traffic(mix, 2**31 + 3, 1000)
        n = mix["pool"]
        for key, lens in (("prompt_len", t.prompt_lens),
                          ("output_len", t.output_lens)):
            spec = mix[key]
            assert spec["lo"] <= lens.min() and lens.max() <= spec["hi"]
            assert abs(statistics.median(lens.tolist()) - spec["median"]) \
                <= 0.05 * spec["median"]
        pairs = sorted(zip(t.prompt_lens.tolist(), t.output_lens.tolist()))
        assert sorted(t.sizes(i) for i in range(n)) == pairs


def test_new_files_are_found_by_name(tiny_root, tmp_path):
    """A new cell and a new per-layer metric need only their files and an
    entry in BENCHMARK.json."""
    import shutil
    root = tmp_path / "bench"
    shutil.copytree(tiny_root, root)
    spec = json.loads((root / "zipbench/workloads/tiny-dsv2-resident.json")
                      .read_text())
    spec["warmup_steps"] = 2
    (root / "zipbench/workloads/tiny-new-cell.json").write_text(
        json.dumps(spec))
    (root / "zipbench/metrics/zz_window_steps.py").write_text(
        "def read(v):\n    return float(len(v.steps))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny-new-cell", "config":
                               "dsv2-tiny", "traffic": "tiny.closed2",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "zz_window_steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "out_tok_s",
                               "workloads": ["tiny-new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, last, err = run_cell(root, "tiny-new-cell", trace=1)
    assert rc == 0, err[-3000:]
    assert last["metrics"]["zz_window_steps"]["value"] > 0


CHECK_MODULES = """
bad = sorted({m.split('.')[0] for m in sys.modules
              if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'repro',
                                     'benchmarks')})
print(json.dumps({'banned': bad, 'port': 'repro_torch' in sys.modules}),
      file=sys.stderr)
"""


def test_no_jax_or_reference_package_loaded(tiny_root):
    rc, last, err = run_cell(tiny_root, "tiny-dsv2-resident",
                             epilogue=CHECK_MODULES)
    assert rc == 0, err[-3000:]
    seen = json.loads(err.strip().splitlines()[-1])
    assert seen == {"banned": [], "port": True}


@pytest.mark.parametrize("name,rc_want", [("jax", 5), ("repro", 5),
                                          ("jaxtools", 0),
                                          ("repro_extra", 0)])
def test_banned_module_check_compares_top_level_names(tiny_root, name,
                                                      rc_want):
    """A loaded ``jax`` or ``repro`` refuses the run with no result; a
    module whose name only begins with one of them passes."""
    prelude = (f"import types; sys.modules[{name!r}] = "
               f"types.ModuleType({name!r})")
    rc, last, err = run_cell(tiny_root, "tiny-dsv2-resident",
                             prelude=prelude)
    assert rc == rc_want, err[-2000:]
    if rc_want:
        assert last is None and name in err
    else:
        assert last is not None and last["correct"]


def test_refuses_without_a_card():
    """On a machine with no CUDA card: another exit code than 0, and no
    result line."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "zipbench/run.py", "--workload",
                        "dsv2lite-b16-resident", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env=env,
                       )
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_refuses_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and zipbench/, a run
    fails before printing a result."""
    import shutil
    root = tmp_path / "alone"
    shutil.copytree(REPO / "zipbench", root / "zipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from zipbench.harness import main\n"
            "sys.exit(main(['--workload', 'dsv2lite-b16-resident', '--seed', "
            "'1', '--seconds', '1'], root=%r, device='cpu'))\n"
            % (str(root), str(root)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "repro_torch" in p.stderr


def test_benchmark_file_keeps_the_contract():
    """Names, units, one-line texts and the keys of each entry."""
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(set(names)) == len(names)
    for n in names:
        assert set(n) <= NAME_OK and len(n) <= 64 and n[0] not in ".-"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        assert (REPO / "zipbench/workloads" / f"{w['name']}.json").exists()
        assert (REPO / "zipbench/traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["per_layer"]:
        assert (REPO / "zipbench/metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
