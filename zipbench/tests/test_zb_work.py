"""The frozen work arithmetic against sums written out by hand."""
import pytest

from zipbench import modelcfg, work
from zipbench.tests.tiny import REPO


def cfg(f):
    return modelcfg.model_config(modelcfg.load(REPO / "zipbench/configs" / f))


def test_deepseekv2_lite_step():
    """One row at KV length 10 through the 3 held layers."""
    head = 2 * 2048 * 102400
    mla = (2 * 2048 * 16 * 192          # wq
           + 2 * 2048 * (512 + 64)      # wkv_a
           + 2 * 16 * 128 * 512         # q_nope into the latent
           + 2 * 16 * 512 * 128         # latent out through w_v
           + 2 * 16 * 128 * 2048        # wo
           + 2 * 16 * 10 * 576 + 2 * 16 * 10 * 512)
    dense = 3 * 2 * 2048 * 10944
    moe = 2 * 2048 * 64 + 6 * 3 * 2 * 2048 * 1408 + 3 * 2 * 2048 * 2816
    assert head + 3 * mla + dense + 2 * moe == 914_878_464
    assert work.step_flops(cfg("deepseekv2_lite.json"), [10]) == 914_878_464
    assert work.step_flops(cfg("deepseekv2_lite.json"), [10, 10]) == \
        2 * 914_878_464


def test_deepseekv2_lite_rows_at_their_own_lengths():
    """Two rows at KV lengths 10 and 200: only the attention over the cache
    grows, 2 * 16 * (576 + 512) FLOPs a position in each of 3 layers."""
    c = cfg("deepseekv2_lite.json")
    extra = 3 * 190 * 2 * 16 * (576 + 512)
    assert work.step_flops(c, [10, 200]) == 2 * 914_878_464 + extra


@pytest.mark.parametrize("f,distinct,pairs,nbytes,flops", [
    ("deepseekv2_lite.json", 6, 6, 6 * 3 * 2048 * 1408 * 2 + 2 * 6 * 2048 * 2,
     2 * 6 * 2048 * 1408 * 3),
    ("deepseekv2_lite.json", 40, 96,
     40 * 3 * 2048 * 1408 * 2 + 2 * 96 * 2048 * 2,
     2 * 96 * 2048 * 1408 * 3)])
def test_expert_ffn_least_work(f, distinct, pairs, nbytes, flops):
    b, fl = work.expert_ffn_work(cfg(f), distinct, pairs)
    assert (b, fl) == (nbytes, flops)
    assert work.least_seconds(b, fl) == max(b / 3.35e12, fl / 989e12)
