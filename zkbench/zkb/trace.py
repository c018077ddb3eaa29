"""The traced run: the program's phases as spans on the profiler's clock,
the card's operations from ``torch.profiler``, and their reduction.

The prover's ``phase_times`` dict gets a ``Spans`` object: the program's
``PhaseClock`` synchronizes the card and sets ``times[phase]`` at the end
of each phase, and ``Spans`` closes a ``record_function`` range there, so
each phase is one range on the profiler's clock holding all of its device
work.  Every operation the card ran (kernels, copies, fills) is an
interval; the busy time is their union.
"""

from __future__ import annotations

import bisect

import torch

SPAN = "zkb.span."
WINDOW = "zkb.window"
OUTSIDE = "outside_phases"


class Spans(dict):
    """A ``phase_times`` dict that also marks each phase on the profiler."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log  # names of the ranges, in order, for every request
        self._open = None
        self._next()

    def _next(self):
        self._open = torch.profiler.record_function(f"{SPAN}{len(self.log)}")
        self._open.__enter__()

    def _close(self, name: str):
        self._open.__exit__(None, None, None)
        self.log.append(name)

    def __setitem__(self, name, seconds):
        super().__setitem__(name, seconds)
        self._close(name)
        self._next()

    def end(self):
        """Close the range after the last phase (the return to the loop)."""
        self._close(OUTSIDE)


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    return f() if f is not None else getattr(ev, what + "_us")() * 1000


def collect(prof, log: list) -> dict:
    """The profile as seconds on one clock: the window, the phase spans
    [(phase, start, end)] and the device operations [(name, start, end)]."""
    spans, device, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start")
        end = start + ev.duration_ns() if hasattr(ev, "duration_ns") else _ns(ev, "end")
        on_card = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith("zkb."):
            if on_card:  # the card's copy of a range: its kernels are already here
                continue
        elif on_card:
            device.append((name, start * 1e-9, end * 1e-9))
            continue
        if name.startswith(SPAN):
            spans.append((log[int(name[len(SPAN):])], start * 1e-9, end * 1e-9))
        elif name == WINDOW:
            window = (start * 1e-9, end * 1e-9)
    spans.sort(key=lambda s: s[1])
    device.sort(key=lambda d: d[1])
    return {"window": window, "spans": spans, "device": device}


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], sorted."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy(device, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(((d[1], d[2]) for d in device), lo, hi))


def busy_in(device, windows) -> float:
    """Device seconds inside each window of `windows`, summed."""
    device = sorted(device, key=lambda d: d[1])
    starts = [d[1] for d in device]
    longest = max((d[2] - d[1] for d in device), default=0.0)
    total = 0.0
    for lo, hi in windows:
        near = device[bisect.bisect_left(starts, lo - longest):bisect.bisect_left(starts, hi)]
        total += busy(near, lo, hi)
    return total


def breakdown(trace: dict) -> dict:
    """The ten device operations with the most time, and the card's idle
    time summed by the phase the host was in (outside_phases: between a
    request's phases and between requests)."""
    lo, hi = trace["window"]
    per_op: dict = {}
    for name, s, e in trace["device"]:
        per_op[name[:160]] = per_op.get(name[:160], 0.0) + (min(e, hi) - max(s, lo))
    ops = sorted(((n, t) for n, t in per_op.items() if t > 0), key=lambda kv: -kv[1])[:10]
    gaps, t = [], lo
    for s, e in union(((d[1], d[2]) for d in trace["device"]), lo, hi):
        if s > t:
            gaps.append((t, s))
        t = e
    if hi > t:
        gaps.append((t, hi))
    spans = trace["spans"]  # sorted, one after another
    idle: dict = {}
    j = 0
    for gs, ge in gaps:
        while j < len(spans) and spans[j][2] <= gs:
            j += 1
        rest, k = ge - gs, j
        while k < len(spans) and spans[k][1] < ge:
            overlap = min(ge, spans[k][2]) - max(gs, spans[k][1])
            if overlap > 0:
                idle[spans[k][0]] = idle.get(spans[k][0], 0.0) + overlap
                rest -= overlap
            k += 1
        if rest > 0:
            idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + rest
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": [[n, t] for n, t in top]}


def per_proof_ms(run, match) -> float | None:
    """Milliseconds a proof of the program's phases whose names `match`
    (``phase_times``: the card synchronized at each phase's end), summed
    over the traced window; None without phase times."""
    if not run.phases or not run.proofs:
        return None
    total = sum(s for ph in run.phases for name, s in ph.items() if match(name))
    return 1e3 * total / run.proofs
