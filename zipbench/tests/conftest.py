import sys
from pathlib import Path

import pytest

_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from zipbench.tests.tiny import make_root
    return make_root(tmp_path_factory.mktemp("zb"))
