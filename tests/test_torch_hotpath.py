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
