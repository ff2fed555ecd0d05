"""``blocked_ms`` in the kanana2 cell: the engine's round trip over 128
slots a layer (see ``blocked_ms.py``)."""
from zipbench.metrics.blocked_ms import read  # noqa: F401
