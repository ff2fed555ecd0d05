"""``expert_gemm_roofline`` in the kanana2 cell: the slab GEMM at expert
width 768 (see ``expert_gemm_roofline.py``)."""
from zipbench.metrics.expert_gemm_roofline import read  # noqa: F401
