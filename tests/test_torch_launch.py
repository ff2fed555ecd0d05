"""``distributed/launch.spawn_ranks``: results in rank order, and no rank
failure passes unseen — a rank that raises, dies or hangs makes the call
raise within its deadline, with every rank stopped."""
import time

import pytest

from repro_torch.distributed.launch import spawn_ranks

import _torch_ranks


def test_results_in_rank_order(tmp_path):
    assert spawn_ranks(_torch_ranks.faulty_rank, 3, timeout_s=120,
                       args=("none",), store_dir=str(tmp_path)) == [0, 1, 2]


@pytest.mark.parametrize("how, error, match", [
    ("raise", RuntimeError, "(?s)rank 1 of 3 failed:.*rank 1 raised"),
    ("exit", RuntimeError, r"without a result .*\(1, 3\)"),
    ("hang", TimeoutError, "not done after"),
])
def test_a_failed_rank_raises(tmp_path, how, error, match):
    timeout = 10 if how == "hang" else 120
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        spawn_ranks(_torch_ranks.faulty_rank, 3, timeout_s=timeout,
                    args=(how,), store_dir=str(tmp_path))
    assert time.monotonic() - t0 < timeout + 30
    assert not list(tmp_path.iterdir())       # the store is removed


def test_world_must_be_positive():
    with pytest.raises(ValueError):
        spawn_ranks(_torch_ranks.faulty_rank, 0)
