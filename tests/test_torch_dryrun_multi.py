"""The port's multi-rank dry run (entry.dryrun_multi, the counterpart of
__graft_entry__.dryrun_multichip) on gloo worlds of 2 and 4 CPU ranks.

The dry run checks itself and raises on any failure: the batched hash on a
(2, n/2) mesh against the unsharded batch, the sharded Straus MSM against
a host MSM, the field sum against Python integers, the four-step NTT
against the single-device NTT, and the toy circuit's sharded proof, which
must verify and must not verify a wrong public input.  The two worlds run
at once (tests/torch_world.py's threads, here around dryrun_multi).
"""

import threading

import pytest
import torch

from zkmember_tpu_torch import entry

RANKS = (2, 4)


@pytest.fixture(scope="module")
def reports():
    torch.set_num_threads(1)
    out: dict = {}

    def run(n):
        try:
            out[n] = entry.dryrun_multi(n, device="cpu")
        except BaseException as e:  # noqa: BLE001 - raised again by the tests
            out[n] = e

    threads = [threading.Thread(target=run, args=(n,), daemon=True) for n in RANKS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "a dry run did not finish"
    return out


@pytest.mark.parametrize("n_ranks", RANKS)
def test_dryrun_multi_on_gloo(reports, n_ranks):
    report = reports[n_ranks]
    if isinstance(report, BaseException):
        raise report
    assert report["world_size"] == n_ranks and report["backend"] == "gloo"
    assert set(report["steps_s"]) == {"hash_s", "msm_s", "field_sum_s", "ntt_s", "prove_s"}


def test_dryrun_multi_refuses_other_rank_counts():
    with pytest.raises(ValueError, match="power-of-two"):
        entry.dryrun_multi(3, device="cpu")
