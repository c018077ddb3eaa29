"""Every metric reader on a recorded run (phases, spans and device
operations on one clock, as ``zkb.trace.collect`` returns them), and the
closed loop's arithmetic: whole requests only, and a stall counts."""

import os

import pytest

from zkb import loop, spec
from zkb import trace as tr
from zkb.loop import Run
from conftest import ROOT


def reader(name):
    return spec.load_module(spec.reader_path(name, ROOT), "r_" + name.replace(".", "_"))


def recorded_run():
    """Two requests of one proof over [0, 1] s; each request's phases one
    after another; the card busy 0.10 s in each MSM span (of 0.15 s)."""
    spans, device = [], []
    phases = []
    for t0 in (0.0, 0.5):
        seq = [("matrix_evals", 0.05), ("h_pipeline", 0.05), ("witness_planes", 0.02),
               ("g1_select_reduce", 0.10), ("g1_finish", 0.05), ("fetch", 0.01),
               ("assemble", 0.09), (tr.OUTSIDE, 0.04)]
        t, ph = t0, {}
        for name, d in seq:
            spans.append((name, t, t + d))
            if name != tr.OUTSIDE:
                ph[name] = d
            if name == "h_pipeline":
                device.append(("k2", t + 0.01, t + 0.04))
            if name == "g1_select_reduce":
                device += [("k1", t + 0.01, t + 0.08), ("k1b", t + 0.07, t + 0.09)]
            if name == "g1_finish":
                device.append(("finish", t + 0.01, t + 0.03))
            t += d
        phases.append(ph)
    reqs = [{"positions": [0], "proofs": [("p",)], "latency": 0.41},
            {"positions": [1], "proofs": [("p",)], "latency": 0.40}]
    return Run(setup_s=12.5, window_s=1.0, proofs=2, requests=reqs, phases=phases,
               trace={"window": (0.0, 1.0), "spans": spans, "device": device},
               msm_least_s=0.02)


def test_the_end_to_end_readers():
    run = recorded_run()
    assert reader("setup_s").read(run) == 12.5
    assert reader("prove_s").read(run) == 0.5
    assert reader("proofs_per_s").read(run) == 2.0


def test_the_span_readers_give_ms_a_proof():
    run = recorded_run()
    assert reader("witness_ms.single").read(run) == pytest.approx(70.0)
    assert reader("assemble_ms.batch").read(run) == pytest.approx(90.0)
    assert reader("h_pipeline_ms.single").read(run) == pytest.approx(50.0)
    assert reader("msm_ms.batch").read(run) == pytest.approx(150.0)


def test_the_device_readers_and_the_breakdown():
    run = recorded_run()
    # busy: 0.03 (K2) + 0.08 (K1 and K1b overlapping) + 0.02 (finish), twice
    assert tr.busy(run.trace["device"], 0.0, 1.0) == pytest.approx(0.26)
    assert reader("device_idle.single").read(run) == pytest.approx(74.0)
    # least 0.02 s a proof over 0.10 s of MSM busy time a proof
    assert reader("msm_roofline.batch").read(run) == pytest.approx(20.0)
    b = tr.breakdown(run.trace)
    names = [n for n, _ in b["device_ops"]]
    assert names[:2] == ["k1", "k2"] and set(names) == {"k1", "k2", "k1b", "finish"}
    idle = dict(b["idle_gaps"])
    assert idle["assemble"] == pytest.approx(0.18) and idle["matrix_evals"] == pytest.approx(0.10)
    assert idle[tr.OUTSIDE] == pytest.approx(0.26)  # 0.04 a request and the gaps after each
    assert sum(idle.values()) == pytest.approx(0.74)


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = recorded_run()
    empty = Run(**dict(run.__dict__, phases=[], trace=None))
    for name in ("witness_ms.single", "msm_ms.batch", "msm_roofline.single", "device_idle.batch"):
        assert reader(name).read(empty) is None
    no_card = Run(**dict(run.__dict__, trace=dict(run.trace, device=[])))
    assert reader("msm_roofline.single").read(no_card) is None
    assert reader("device_idle.single").read(no_card) is None


def test_every_metric_of_benchmark_json_has_a_reader():
    import json

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(spec.reader_path(m["name"], ROOT)), m["name"]


def test_a_span_reader_sums_its_own_phases_by_whole_name():
    run = recorded_run()
    more = [dict(ph, h=1.0, pipeline=1.0, h_pipeline_extra=1.0) for ph in run.phases]
    assert reader("h_pipeline_ms.batch").read(Run(**dict(run.__dict__, phases=more))) == \
        pytest.approx(50.0)


class Clock:
    """A clock that a fake request moves on."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def closed_loop(durations, seconds, P):
    """The rate and time a proof of `measure` over requests of P proofs that
    take `durations` seconds in turn."""
    clock = Clock()

    def request(k):
        clock.t += durations[k % len(durations)]
        return {"positions": list(range(P)), "proofs": ["p"] * P}

    records, window_s = loop.measure(request, seconds, clock=clock)
    proofs = sum(len(r["proofs"]) for r in records)
    run = Run(window_s=window_s, proofs=proofs)
    return records, window_s, reader("proofs_per_s").read(run), reader("prove_s").read(run)


def test_the_window_holds_whole_requests_and_ends_at_the_last_return():
    records, window_s, rate, per_proof = closed_loop([1.5], 10.0, 8)
    assert len(records) == 7 and window_s == 10.5  # the 7th request crosses 10 s
    assert rate == 56 / 10.5 and per_proof == 10.5 / 56
    assert all(r["latency"] == 1.5 for r in records)
    records, window_s, _, per_proof = closed_loop([0.25], 3.0, 1)
    assert len(records) == 12 and window_s == 3.0 and per_proof == 0.25


def test_a_stall_inside_the_window_lowers_the_rate_and_raises_the_time_a_proof():
    _, _, rate, per_proof = closed_loop([1.0], 10.0, 8)
    _, _, stalled_rate, stalled = closed_loop([1.0, 1.0, 4.0], 10.0, 8)
    assert stalled_rate < rate and stalled > per_proof
    _, _, _, single = closed_loop([0.5], 10.0, 1)
    _, _, _, one_stall = closed_loop([0.5] * 9 + [3.0], 10.0, 1)
    assert one_stall > single
