"""The comparison fails a run whose timed path is broken underneath: the
harness runs as on the card (its look for a card skipped) with one fault
planted in the port, and ``correct`` comes out false."""
import pytest

from zipbench.tests.tiny import run_cell

# a served token altered where it is produced
ALTER_ROWS = """
from repro_torch.serving.server import BatchServer
_orig = BatchServer._sample_rows
def _altered(self, lg, active):
    toks, logits = _orig(self, lg, active)
    toks = toks.copy(); toks[0] = (toks[0] + 1) % self.cfg.vocab_size
    return toks, logits
BatchServer._sample_rows = _altered
"""

# a step that returns its state unchanged: the new K/V never lands
FROZEN_ROWS = """
from repro_torch.serving.kv_cache import KVPagePool
KVPagePool.commit = lambda self, views, rids, positions: None
"""

# half of the batch left out: its rows answered with the other half's
HALF_ROWS = """
from repro_torch.serving.zipserve import ZipServer
_orig = ZipServer.decode_rows
def _halved(self, tokens, *a, **k):
    lg, caches = _orig(self, tokens, *a, **k)
    B = lg.shape[0]
    if B > 1:
        lg = lg.clone(); lg[(B + 1) // 2:] = lg[:B // 2]
    return lg, caches
ZipServer.decode_rows = _halved
"""

CASES = {"altered": ALTER_ROWS, "frozen": FROZEN_ROWS, "halved": HALF_ROWS}


@pytest.mark.parametrize("fault", list(CASES))
def test_fault_fails_the_comparison(tiny_root, fault):
    rc, last, err = run_cell(tiny_root, "tiny-dsv2-resident", seed=3,
                             prelude=CASES[fault])
    assert rc == 0, err[-3000:]
    assert last["correct"] is False, last["checks"]
    assert last["checks"]["gap_max"]["value"] > \
        last["checks"]["gap_max"]["limit"]
