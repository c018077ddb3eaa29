"""One run of one cell: set-up, the measured window, the check, the line.

Set-up (``setup_s``, from the process's start to the window's): the
kernel library (built once into the checkout's ``build/``), the registrar,
the pool's circuits (the members the window re-presents, synthesized once
here), the proof system's set-up on the device from the seed
(``zkbench/systems/<system>.py``), and warm-up requests of the cell's own
shape that prove every circuit of the pool once.  The window: a closed
loop of requests, each proving its pool members with fresh (r, s) from the
seed, until ``seconds`` have passed; it ends at the return of the request
that crossed them, so it holds only whole requests, and the prover's
return follows its device -> host fetch, so it holds all the card's work.
With ``trace`` the same loop runs under ``torch.profiler`` with the
program's phase times on, and the per-layer readers get its spans and
device operations.  Then the peak memory is read, a sample of the key
copied to the host, the program's state freed, and the reference judges
every proof, and the pool's public inputs against those the reference
derives from the seed.  What the host gave the process over the window (threads,
cores, CPU seconds, each request's wall and main-thread CPU seconds) goes
to stderr, for the runs' spread.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import time

from zkb import trace as tr
from zkb import traffic
from zkb.peaks import least_seconds


class Run:
    """What a metric reader reads (times in seconds)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def log(msg: str, t0: float) -> None:
    print(f"# [{time.perf_counter() - t0:8.2f}s] {msg}", file=sys.stderr, flush=True)


def host_state() -> dict:
    """What the host gives this process now: torch's threads, the cores it
    may run on, its CPU seconds so far (all threads; user and system) and
    its page faults and context switches."""
    import torch

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"threads": torch.get_num_threads(), "cores": len(os.sched_getaffinity(0)),
            "cpu_s": time.process_time(), "user_s": ru.ru_utime, "sys_s": ru.ru_stime,
            "minflt": ru.ru_minflt, "majflt": ru.ru_majflt, "nivcsw": ru.ru_nivcsw}


def quartiles(xs: list) -> str:
    xs = sorted(xs)
    return " ".join(f"{xs[min(len(xs) - 1, int(q * len(xs)))]:.4f}" for q in (0, 0.25, 0.5, 0.75)) \
        + f" {xs[-1]:.4f}"


def measure(request, seconds: float, clock=time.perf_counter,
            max_requests: int | None = None) -> tuple[list, float]:
    """The closed loop: request(k) for k = 0, 1, ... (each returns its
    record, to which its latency is added) until `seconds` have passed since
    the window opened, or `max_requests`.  The window ends at the return of
    the request that crossed `seconds`, so it holds whole requests only and
    a stall anywhere in it lengthens it.  Returns (records, window seconds)."""
    records = []
    t_start = clock()
    while True:
        t1 = clock()
        rec = request(len(records))
        t2 = clock()
        rec["latency"] = t2 - t1
        records.append(rec)
        if t2 - t_start >= seconds or (max_requests and len(records) >= max_requests):
            return records, t2 - t_start


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        make_prover=None, max_requests: int | None = None) -> dict:
    """One run; returns the result line's fields and the numbers compared.
    make_prover(cell, state, make_ref) -> prove(css, rng, phase_times) ->
    proofs: the system's program entry unless a test or the control puts
    another in its place (make_ref() gives the reference of the run's key)."""
    import torch

    from zkmember_tpu_torch import kernels

    system = cell.system
    make_prover = make_prover or system.program_prover
    dev = torch.device(device)
    mix = cell.traffic
    if dev.type == "cuda":
        kernels.library()
        log("kernel library loaded", t0)
    reg = cell.circuit.build(cell.config, seed, dev)
    members = traffic.pool(mix, reg.members, seed)
    log(f"registrar of {reg.members} members; the pool's members {members}", t0)
    css = [reg.synthesize(i) for i in members]
    log(f"{len(css)} circuits synthesized: {css[0].num_constraints} constraints, "
        f"{css[0].num_variables} variables each", t0)
    if reg.curve != cell.config["curve"]:
        raise ValueError(f"the registrar's curve {reg.curve} is not the configuration's")
    state = system.setup(cell.config, css[0], seed, dev, lambda msg: log(msg, t0))
    log("key planes and tables resident", t0)
    prove = make_prover(cell, state, lambda: system.reference(cell.config, css[0], seed))
    warm_rng = traffic.stream(seed, "warm_up_proofs")
    for pos in traffic.warm_up(mix):
        prove([css[i] for i in pos], warm_rng, None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()  # the set-up's objects leave the collector's scans
    t_window = time.perf_counter()
    setup_s = t_window - t0
    log("warm-up requests done; window opens", t0)

    reqs = traffic.requests(mix)
    proof_rng = traffic.stream(seed, "proofs")
    span_log, phases = [], []
    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.__enter__()
        window_range = torch.profiler.record_function(tr.WINDOW)
        window_range.__enter__()

    def request(k: int) -> dict:
        pos = next(reqs)
        spans = tr.Spans(span_log) if trace else None
        c1 = time.thread_time()
        try:
            proofs = list(prove([css[i] for i in pos], proof_rng, spans))
        except Exception as e:  # a request that fails counts; the loop goes on
            print(f"# request failed: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
            proofs = []
        if spans is not None:
            spans.end()
            phases.append(dict(spans))
        return {"positions": pos, "proofs": (proofs + [None] * len(pos))[: len(pos)],
                "main_cpu": time.thread_time() - c1}

    host0, main0 = host_state(), time.thread_time()
    records, window_s = measure(request, seconds, max_requests=max_requests)
    attempted = sum(len(r["positions"]) for r in records)
    failed = sum(p is None for r in records for p in r["proofs"])
    host1 = host_state()
    main_s = time.thread_time() - main0
    trace_data = None
    if prof is not None:
        window_range.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        trace_data = tr.collect(prof, span_log)
        del prof
    gc.unfreeze()
    log(f"window closed: {len(records)} requests, {attempted} proofs in {window_s:.3f}s; request "
        f"seconds min q1 median q3 max {quartiles([r['latency'] for r in records])}; the main "
        f"thread's CPU s {quartiles([r['main_cpu'] for r in records])}", t0)
    d = {k: host1[k] - host0[k] for k in ("cpu_s", "user_s", "sys_s", "minflt", "majflt", "nivcsw")}
    log(f"host: torch threads {host1['threads']}, cores {host1['cores']}; over {window_s:.3f}s "
        f"the process used {d['cpu_s']:.3f} CPU s (user {d['user_s']:.3f}, system "
        f"{d['sys_s']:.3f}), its main thread {main_s:.3f}; {d['minflt']} minor and {d['majflt']} "
        f"major page faults, {d['nivcsw']} involuntary switches", t0)
    log("each request's seconds, wall/main-thread CPU: " + " ".join(
        f"{r['latency']:.3f}/{r['main_cpu']:.3f}" for r in records), t0)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    key = system.read_back(state, cell.config, seed)
    least = least_seconds(system.msm_rows(state, cell.config))
    log(f"MSM problem: {least[2]:.4g} IMADs, {least[3]:.4g} bytes a proof; least "
        f"{least[0] * 1e3:.3f} ms a proof, bound by {least[1]}", t0)
    for rec in records:
        rec["proofs"] = [None if p is None else system.answer(p) for p in rec["proofs"]]
    del state, prove
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = system.reference(cell.config, css[0], seed)
    publics = cell.publics.publics(cell.config, seed, members)
    pool = [(system.assignment(ref, cs.values), publics[i]) for cs, i in zip(css, members)]
    nums = system.numbers(ref, cell.config, pool, key, records, seed, attempted)
    log(f"reference checked {attempted} proofs in {time.perf_counter() - t_ref:.2f}s", t0)

    run_rec = Run(setup_s=setup_s, window_s=window_s, proofs=attempted - failed,
                  requests=records, phases=phases, trace=trace_data, msm_least_s=least[0])
    return {"attempted": attempted, "failed": failed, "peak": peak, "numbers": nums,
            "run": run_rec}
