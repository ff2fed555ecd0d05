"""The whole step's share of the card's peak: the frozen model FLOPs of the
window's decode steps (``work.step_flops``: each row's token through every
held layer, attention over its own KV length, the LM head) over the
window's seconds times 989 TFLOP/s, %."""
from zipbench import work


def read(v):
    if not v.steps:
        return None
    flops = sum(work.step_flops(v.cfg, s.kv_lens) for s in v.steps)
    return 100.0 * flops / (v.seconds * work.PEAK_BF16_FLOPS)
