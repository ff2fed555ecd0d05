"""A tiny copy of the benchmark for CPU tests: the harness's files copied
into a temporary root, with tiny configurations, mixes and cells of its
own, run in a subprocess on the CPU (``harness.main(device="cpu")``)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_DSV2 = {
    "name": "dsv2-tiny", "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 128, "intermediate_size": 256,
    "kv_lora_rank": 32, "model_type": "deepseek_v2",
    "moe_intermediate_size": 64, "moe_layer_freq": 1, "n_routed_experts": 8,
    "n_shared_experts": 1, "norm_topk_prob": False, "num_attention_heads": 4,
    "num_experts_per_tok": 2, "num_hidden_layers": 3,
    "num_key_value_heads": 4, "q_lora_rank": None, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 16, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 1,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1,
    "scoring_func": "softmax", "tie_word_embeddings": False,
    "topk_method": "greedy", "v_head_dim": 32, "vocab_size": 512,
    "assumed": {"zlib_level": 1, "router_skew_alpha": 1.15}}

MIXES = {
    "tiny.closed2": {"loop": "closed", "clients": 2,
                     "prompt_len": {"dist": "uniform", "lo": 3, "hi": 6},
                     "output_len": {"dist": "uniform", "lo": 4, "hi": 8},
                     "sizes_seed": 1, "pool": 64},
}

CELLS = {
    "tiny-dsv2-resident": ("dsv2-tiny", "tiny.closed2", {
        "driver": "batch_server",
        "server": {"device_cache": True, "ffn_impl": "ragged", "L": 2,
                   "pool_sizes": "all"},
        "warm_all_experts": True,
        "warmup_steps": 4, "profile": {"start_s": 0.0, "seconds": 0.5},
        "check": {"gap_max": 0.05, "sample_tokens": 20,
                  "sample_requests": 4}}),
}

def make_root(tmp: Path, cells=None) -> Path:
    """A benchmark root under `tmp`: the harness's code and the tiny
    files; BENCHMARK.json keeps the repository's metrics."""
    root = tmp / "bench"
    shutil.copytree(REPO / "zipbench", root / "zipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfgs = {"dsv2-tiny": TINY_DSV2}
    bench["configs"] = []
    for name, c in cfgs.items():
        f = f"zipbench/configs/{name}.json"
        (root / f).write_text(json.dumps(c))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f, "reduced": [], "why": "test"})
    for name, mix in MIXES.items():
        (root / "zipbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench["workloads"] = []
    for name, (conf, mix, spec) in (cells or CELLS).items():
        (root / "zipbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(spec))
        bench["workloads"].append({"name": name, "config": conf,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    names = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = names
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


RUNNER = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{prelude}
from zipbench.harness import main
rc = main({argv!r}, root={root!r}, device="cpu")
{epilogue}
sys.exit(rc)
"""


def run_cell(root: Path, cell: str, seed=7, seconds=1.5, trace=0,
             prelude="", epilogue="", timeout=300):
    """Run `cell` on the CPU in a subprocess; returns (rc, last stdout
    line as a dict or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = RUNNER.format(root=str(root), src=str(REPO / "src"),
                         argv=argv, prelude=prelude, epilogue=epilogue)
    env = dict(os.environ, OMP_NUM_THREADS="2", TMPDIR=str(root.parent))
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=root)
    lines = [x for x in p.stdout.splitlines() if x.strip()]
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
