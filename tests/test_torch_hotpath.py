"""Host syncs in the port's hot path.

A function of ``src/repro_torch`` marked ``# hot-path`` (a comment on any
line of its ``def`` header, or on the line above the ``def`` or its first
decorator) must not wait for the card or copy to the host: ``.cpu()``,
``.tolist()``, ``.numpy()``, ``.item()`` and ``.synchronize()`` (which
covers ``torch.cuda.synchronize`` and a stream's or event's) are flagged
unless the line, or the line above it, carries ``# host-sync-ok: <reason>``.
The check is per function, as the JAX package's zipcheck pass is: a helper
that a hot function calls is checked only when it is marked itself.
"""
import ast
import textwrap
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FLAG = "# hot-path"
WAIVER = "# host-sync-ok:"
SYNC_ATTRS = ("cpu", "tolist", "numpy", "item", "synchronize")


def _header_lines(fn: ast.AST):
    """1-based line numbers where a function's hot-path flag may sit."""
    first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
    return range(first - 1, fn.body[0].lineno)


def hot_functions(source: str):
    """(qualified name, node) of every ``# hot-path`` function."""
    lines = source.splitlines()
    tree = ast.parse(source)
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(FLAG in lines[i - 1] for i in _header_lines(fn)
                   if 0 < i <= len(lines)):
            continue
        parent = parents.get(fn)
        name = f"{parent.name}.{fn.name}" \
            if isinstance(parent, ast.ClassDef) else fn.name
        out.append((name, fn))
    return out


def host_syncs(source: str):
    """(function, line, call) of every unwaived host sync in the hot
    functions of `source`."""
    lines = source.splitlines()
    found = []
    for name, fn in hot_functions(source):
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in SYNC_ATTRS):
                continue
            near = lines[max(0, node.lineno - 2):node.lineno]
            if any(WAIVER in ln for ln in near):
                continue
            found.append((name, node.lineno, f".{node.func.attr}()"))
    return found


def _sources():
    return sorted(PKG.rglob("*.py"))


def test_hot_path_functions_found():
    names = {f"{p.relative_to(PKG)}:{n}" for p in _sources()
             for n, _ in hot_functions(p.read_text())}
    for want in ("serving/zipserve.py:ZipServer.decode_step",
                 "serving/zipserve.py:ZipServer.decode_rows",
                 "serving/zipserve.py:ZipServer._ffn_ragged",
                 "core/engine.py:ZipMoEEngine._recover_device",
                 "core/slab.py:DeviceSlabCache.gather",
                 "kernels/moe_gemm.py:slab_ragged_gemm"):
        assert want in names, sorted(names)


def test_port_hot_path_has_no_unwaived_host_sync():
    bad = [(str(p.relative_to(PKG)), *hit) for p in _sources()
           for hit in host_syncs(p.read_text())]
    assert not bad, bad


BAD_SNIPPETS = {
    "cpu": "y = x.cpu()",
    "tolist": "ids = x.tolist()",
    "numpy": "a = x.detach().numpy()",
    "item": "v = x.sum().item()",
    "cuda-synchronize": "torch.cuda.synchronize()",
    "stream-synchronize": "torch.cuda.current_stream().synchronize()",
}


def _snippet(body: str, flag: str = "  # hot-path", waiver: str = ""):
    return textwrap.dedent(f"""\
        import torch


        class Server:
            def step(self, x,
                     y):{flag}
                z = x + y
                {waiver}
                {body}
                return z
        """)


@pytest.mark.parametrize("kind", sorted(BAD_SNIPPETS))
def test_seeded_host_sync_is_flagged(kind):
    src = _snippet(BAD_SNIPPETS[kind])
    hits = host_syncs(src)
    assert [(n, c) for n, _, c in hits] == [
        ("Server.step", "." + BAD_SNIPPETS[kind].split(".")[-1].split(
            "(")[0] + "()")]
    # waived on the line above, or not marked hot: not flagged
    assert host_syncs(_snippet(BAD_SNIPPETS[kind],
                               waiver="# host-sync-ok: test")) == []
    assert host_syncs(_snippet(BAD_SNIPPETS[kind], flag="")) == []


def _count_host_copies(monkeypatch, tmp_path, cfg):
    """The tensor host-copy calls of one ``decode_step`` and one
    ``decode_rows`` on the same device-cache server over `cfg`, and the
    server (closed)."""
    import numpy as np
    import torch

    from repro_torch.core.store import build_store
    from repro_torch.models import init_params
    from repro_torch.serving.zipserve import ZipServer

    params = init_params(cfg, seed=0, device="cpu")
    build_store(params, cfg, str(tmp_path), device="cpu")
    zs = ZipServer(params, cfg, str(tmp_path), L=2, device_cache=True,
                   prefetch=False, device="cpu")
    calls = []
    for attr in SYNC_ATTRS[:-1]:              # .synchronize is no method
        orig = getattr(torch.Tensor, attr)

        def counted(self, *a, _orig=orig, _attr=attr, **kw):
            calls.append(_attr)
            return _orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, attr, counted)
    try:
        tok = torch.zeros(2, 1, dtype=torch.long)
        zs.decode_step(tok, zs.init_cache(2, 4), 0)
        step_calls = sorted(calls)
        calls.clear()
        zs.decode_rows(tok, zs.init_cache(2, 4), np.asarray([0, 2]),
                       owners=[1, 2])
        return step_calls, sorted(calls), zs
    finally:
        zs.close()


def test_decode_rows_adds_no_host_sync(tmp_path, monkeypatch):
    """At run time, ``decode_rows`` copies to the host exactly what
    ``decode_step`` copies on the same server (the router's choice, once
    per MoE layer): the per-request accounting reuses that copy."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen2-moe-a2.7b", n_layers=2)
    step_calls, rows_calls, zs = _count_host_copies(monkeypatch, tmp_path,
                                                    cfg)
    assert rows_calls == step_calls, (rows_calls, step_calls)
    assert step_calls.count("cpu") == 2 * len(zs._moe_layers)
    assert zs.request_summary()[1]["steps"] == 1


def test_mla_decode_adds_no_host_sync(tmp_path, monkeypatch):
    """The MLA family (a dense first layer, latent KV): the same host
    copies as the GQA family's, one per MoE layer's router choice, in
    ``decode_step`` and ``decode_rows`` alike; and the MLA decode
    functions are under the static check."""
    from repro_torch.configs import get_smoke_config

    names = {f"{p.relative_to(PKG)}:{n}" for p in _sources()
             for n, _ in hot_functions(p.read_text())}
    assert {"models/attention.py:mla_decode",
            "models/attention.py:mla_decode_rows"} <= names
    cfg = get_smoke_config("deepseekv2-lite", n_layers=3)
    step_calls, rows_calls, zs = _count_host_copies(monkeypatch, tmp_path,
                                                    cfg)
    assert zs._moe_layers == [1, 2]
    assert rows_calls == step_calls, (rows_calls, step_calls)
    assert step_calls.count("cpu") == 2 * len(zs._moe_layers)
