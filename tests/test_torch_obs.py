"""The port's utils/obs.py against the JAX package's, and the card's model.

The reference's work counters (16-bit limb products) must come out equal
for every argument; Profiler's summary, dump text and emitted lines must
equal the reference's for the same phases; throughput_line keeps the
reference's fields.  The card's model (IMADs and bytes of K1 and the MSM
finish) must reproduce the bounds PERF.md records for the main path, to the
four decimals chip_smoke.py logs, and a PhaseClock with neither phase times nor a profiler
must not synchronize the card.
"""

import io
import json

import pytest
import torch

from zkmember_tpu.utils import obs as jobs
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import obs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("n", [16, 24, 48])
def test_mont_mul_work_equals_reference(n):
    for k in (n - 1, n, n + 1):
        assert obs.mont_mul_work(k) == jobs.mont_mul_work(k)


@pytest.mark.parametrize("fp2", [False, True])
@pytest.mark.parametrize("lanes", [1, 64, 255, 256, 16_384])
@pytest.mark.parametrize("n", [16, 24, 48])
def test_straus_msm_work_equals_reference(n, lanes, fp2):
    assert obs.straus_msm_work(lanes, n) == jobs.straus_msm_work(lanes, n)
    assert obs.straus_msm_work(lanes, n, fp2=fp2) == jobs.straus_msm_work(lanes, n, fp2=fp2)
    for nbits, wb, tail in ((255, 4, 64), (377, 4, 1024), (255, 3, 8)):
        got = obs.straus_msm_work(lanes, n, nbits, wb, fp2, tail)
        assert got == jobs.straus_msm_work(lanes, n, nbits, wb, fp2, tail)


def _ticking(start=100.0, step=0.123456):
    t = [start]

    def now():
        t[0] += step
        return t[0]

    return now


def test_profiler_equals_reference(monkeypatch):
    """The same phases (a fake clock in each module) give the same records'
    summary, the same emitted lines and the same dump text."""
    import time

    mine, theirs = [], []
    p = obs.Profiler(emit=mine.append)
    r = jobs.Profiler(emit=theirs.append)
    monkeypatch.setattr(time, "perf_counter", _ticking())
    monkeypatch.setattr(time, "time", _ticking())
    for prof in (p, r):
        with prof.phase("g1_select_reduce"):
            pass
        with prof.phase("fetch", rows=4, route="table"):
            pass
        with prof.phase("g1_select_reduce"):
            with prof.phase("inner"):
                pass
    monkeypatch.undo()
    assert mine == theirs
    assert [json.loads(s)["phase"] for s in mine] == ["g1_select_reduce", "fetch", "inner",
                                                      "g1_select_reduce"]
    assert json.loads(mine[1]) == {"phase": "fetch", "s": 0.1235, "rows": 4, "route": "table"}
    assert p.summary() == pytest.approx(r.summary())
    assert [(x.name, x.meta) for x in p.records] == [(x.name, x.meta) for x in r.records]
    a, b = io.StringIO(), io.StringIO()
    p.dump(a)
    r.dump(b)
    assert a.getvalue() == b.getvalue()
    # g1_select_reduce: one tick, then three (its second run wraps "inner")
    assert a.getvalue().splitlines()[0] == f"  {'g1_select_reduce':<28} {4 * 0.123456:8.3f}s"


def test_dump_and_emit_follow_the_current_stderr(capsys):
    """Both write to sys.stderr as it is at the call (capsys, or
    contextlib.redirect_stderr in chip_smoke.py, must capture them)."""
    p = obs.Profiler(emit=obs.stderr_line)
    p.record("h_pipeline", 0.25)
    p.dump()
    err = capsys.readouterr().err.splitlines()
    assert err == ['# {"phase": "h_pipeline", "s": 0.25}', f"  {'h_pipeline':<28} {0.25:8.3f}s"]


def test_trace_profiler_reads_the_environment_at_each_call(monkeypatch):
    monkeypatch.delenv("ZKMEMBER_TRACE", raising=False)
    assert obs.trace_profiler() is None
    monkeypatch.setenv("ZKMEMBER_TRACE", "1")
    prof = obs.trace_profiler()
    assert prof is not None and prof.emit is obs.stderr_line


def test_phase_clock_without_times_or_profiler_adds_no_synchronization(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    mark = obs.PhaseClock(None, "cuda")
    mark("a")
    mark("b")
    assert synced == []
    times = {}
    prof = obs.Profiler()
    mark = obs.PhaseClock(times, "cuda", prof)
    mark("a")
    mark("a")
    assert len(synced) == 2
    assert set(times) == {"a"} and [r.name for r in prof.records] == ["a", "a"]
    assert prof.summary()["a"] == times["a"]
    mark = obs.PhaseClock(None, "cuda", prof)  # tracing alone synchronizes too
    mark("b")
    assert len(synced) == 3 and prof.summary()["b"] >= 0


def test_throughput_line_keeps_the_reference_fields():
    for work, seconds in ((868_331_520, 16.1933), (10**12, 0.0183), (5, 0.0)):
        got = json.loads(obs.throughput_line("msm_all", work, seconds, 51_800_000_000))
        want = json.loads(jobs.throughput_line("msm_all", work, seconds))
        for k in ("metric", "u32_mults", "seconds", "u32_mults_per_sec"):
            assert got[k] == want[k]
        assert "mfu_vs_vpu_peak" not in got
        assert got["imads"] == 51_800_000_000
        rate = 51_800_000_000 / max(seconds, 1e-9)
        assert got["imads_per_sec"] == round(rate)
        assert got["mfu_vs_imad_peak"] == round(rate / obs.IMAD_PER_S, 4)
        assert got["mfu_vs_kernel_peak"] == round(rate / obs.KERNEL_PEAK_IMAD_PER_S, 4)


def test_kernel_peak_is_the_measured_k2_rate():
    assert obs.mont_mul_imads(24) == 588 and obs.mont_mul_imads(16) == 264
    assert obs.KERNEL_PEAK_IMAD_PER_S == pytest.approx(6.085e12, rel=1e-3)
    assert obs.KERNEL_PEAK_IMAD_PER_S < obs.IMAD_PER_S == 16.75e12


# PERF.md section 6's bounds (ms) of K1 and the finish on the main path, a
# batch of 4 and BW6-761, each from (n, fp2, W, P, R, B, NT) / (n, fp2, W,
# rows, NT), to the four decimals chip_smoke.py logs (PERF.md rounds them to
# three: 1.656, 1.242, 19.470, 6.626, 4.867; 0.111, 0.083, 1.300, 0.443)
@pytest.mark.parametrize("args, ms", [
    ((24, False, 64, 1, 4, 16_384, 1_024), 1.6564),
    ((24, True, 64, 1, 1, 16_384, 1_024), 1.2423),
    ((48, False, 95, 1, 4, 32_768, 2_048), 19.4695),
    ((24, False, 64, 4, 4, 16_384, 1_024), 6.6257),
    ((48, False, 95, 1, 1, 32_768, 2_048), 4.8674),
])
def test_select_reduce_bound_matches_perf_md(args, ms):
    t, by = obs.bound(*obs.select_reduce_work(*args))
    assert (round(t, 4), by) == (ms, "operations")


@pytest.mark.parametrize("args, ms", [
    ((24, False, 64, 4, 1_024), 0.1107),
    ((24, True, 64, 1, 1_024), 0.0830),
    ((48, False, 95, 4, 2_048), 1.2996),
    ((24, False, 64, 16, 1_024), 0.4428),
])
def test_finish_bound_matches_perf_md(args, ms):
    t, by = obs.bound(*obs.finish_work(*args))
    assert (round(t, 4), by) == (ms, "operations")


def test_bound_by_bytes():
    # K2 at (1, 3, 16, 8192) x (16, 8192): bytes bound 0.0011 ms (PERF.md)
    nbytes = (3 * 16 * 8192 + 16 * 8192 + 3 * 16 * 8192) * 4
    t, by = obs.bound(nbytes, 3 * 8192 * obs.mont_mul_imads(16))
    assert (round(t, 4), by) == (0.0011, "bytes")


def test_main_path_imads_match_the_bounds():
    """The trace's imads for the main path's table route (the 16-member key's
    lanes) are the IMADs behind K1's and the finish's four bounds, about
    51.8e9; the on-the-fly route adds the two per-call tables."""
    cfg = groth16.pairing_config("bls12_381")
    ops1, ops2 = (prove_lm.sw_ops(cfg, g2, "cpu") for g2 in (False, True))
    g1 = prove_lm._family_imads(ops1, 4, 16_384, 64, True, 1 << 18, 1)
    g2 = prove_lm._family_imads(ops2, 1, 16_384, 64, True, 1 << 17, 1)
    ms = (1.656, 1.242, 0.111, 0.083)
    assert g1 + g2 == pytest.approx(sum(ms) * 1e-3 * obs.IMAD_PER_S, rel=2e-3)
    assert round((g1 + g2) / 1e9, 1) == 51.8
    otf = prove_lm._family_imads(ops1, 4, 16_384, 64, False, 1 << 18, 1)
    assert otf - g1 == obs.table_work(24, False, 4, 16_384) == 16 * 4 * 16_384 * 12 * 588
    # two slices: two tables, K1s and finishes over half the lanes, one addition a row
    sliced = prove_lm._family_imads(ops1, 4, 16_384, 64, False, 1 << 13, 1)
    half = prove_lm._family_imads(ops1, 4, 8_192, 64, False, 1 << 13, 1)
    assert sliced == 2 * half + obs.add_imads(24, False, 4)
    # one rank of two: K1 over its block, the finish over both blocks' lanes
    d2 = prove_lm._family_imads(ops1, 4, 16_384, 64, True, 1 << 18, 2)
    assert d2 == (obs.select_reduce_work(24, False, 64, 1, 4, 8_192, 512)[1]
                  + obs.finish_work(24, False, 64, 4, 1_024)[1])
    # one rank of four over 128 lanes on the fly: the table of its 32 lanes,
    # K1 over the block padded to 64, the finish over four ranks' 32 lanes
    d4 = prove_lm._family_imads(ops1, 4, 128, 64, False, 1 << 18, 4)
    assert d4 == (obs.table_work(24, False, 4, 32)
                  + obs.select_reduce_work(24, False, 64, 1, 4, 64, 32)[1]
                  + obs.finish_work(24, False, 64, 4, 128)[1])
