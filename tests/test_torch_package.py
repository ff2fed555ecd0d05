"""Package rules of the PyTorch port (``src/repro_torch``):

* it imports with JAX made unimportable, and neither it nor
  ``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or anything of the JAX
  package ``repro`` (AST scan of every import statement);
* its entry points run on the CUDA card unless the caller passes
  ``device="cpu"``: with no card visible they raise instead of falling
  back to the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PKG).with_suffix(
        "").parts) for p in PKG.rglob("*.py") if p.name != "__init__.py")


def test_imports_without_jax():
    """Every module of the port imports in a process where ``import jax``
    fails: the training modules and both CLIs among them."""
    mods = _modules()
    for m in ("training.optimizer", "training.data", "training.train_step",
              "training.checkpoint", "launch.train", "launch.serve"):
        assert f"repro_torch.{m}" in mods, m
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes', 'repro'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.')\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse((REPO / path).read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in BANNED]
    assert not bad, (path, bad)


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    """With no card visible and no explicit device, every entry point
    raises; ``device="cpu"`` is the only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core.store import build_store
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        init_params(cfg)
    with pytest.raises(RuntimeError):
        init_cache(cfg, 1, 4)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        build_store(params, cfg, str(tmp_path / "s"))
    build_store(params, cfg, str(tmp_path / "s"), device="cpu")
    with pytest.raises(RuntimeError):
        ZipServer(params, cfg, str(tmp_path / "s"))
    zs = ZipServer(params, cfg, str(tmp_path / "s"), device="cpu")
    zs.close()
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.serving.kv_cache import KVPagePool
    with pytest.raises(RuntimeError):
        KVPagePool(cfg)
    KVPagePool(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--mode", "resident", "--requests", "1"])
    from repro_torch.launch.train import main as train_main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_raise(tmp_path):
    """Options whose kernels or modules are not ported yet refuse loudly."""
    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer
    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=1)
    params = init_params(cfg, seed=0, device="cpu")
    build_store(params, cfg, str(tmp_path), device="cpu")
    with pytest.raises(NotImplementedError):
        ZipServer(params, cfg, str(tmp_path), device="cpu", mesh_devices=2)
    # the FFN paths and options ported since construct on the CPU
    for kw in (dict(ffn_impl="grouped"), dict(ffn_impl="loop"),
               dict(fused_recovery=True), dict(profile_p_times=True),
               dict(device_recovery=True), dict(mem_budget=1e6),
               dict(mem_budget=1e6, device_cache=True)):
        ZipServer(params, cfg, str(tmp_path), device="cpu", **kw).close()
    # fused recovery keeps host planes; device slabs keep spliced tensors
    with pytest.raises(AssertionError):
        ZipServer(params, cfg, str(tmp_path), device="cpu",
                  fused_recovery=True, device_cache=True)
