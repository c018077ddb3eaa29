#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed S]
        [--phases device,build,k2,k1,prove,options,multi,k3,setup,prove_v1,cli,
                  prove_batch,harness,bench,hash,scale,bw6,marlin[,bench_sweep][,profile]]

Phases (each raises on failure, so the script exits non-zero):
  device  the card's name and power limit (nvidia-smi)
  build   nvcc builds the hand-written kernels (zkmember_tpu_torch/csrc)
  k2      Montgomery-product kernel against its plain PyTorch version on the
          card, bit for bit, at BLS12-381 Fq/Fr and BW6-761 Fq widths; then
          timed at each operand shape of one prove_lm proof (k2_proof_shapes)
          and at one wave of the per-key table build: the wrapper (ms), the
          kernel alone (device_ms) and the host's time per call (host_us)
  k1      select+reduce kernel against its plain version from random points
          at R=1, B=4096, limb for limb, every variant: BLS12-381 G1 (Fp) and
          G2 (Fp2) at W=64, BW6-761 G1 and G2 (Fp at n = 48, b3 = -3 and 12)
          at W=95; then the finish kernel (tail reduction + Horner join) on
          its output against the plain finish, limb for limb and as points
  prove   the 16-member Groth16 BLS12-381 membership proof from the committed
          key artifacts/groth16_bls12_381_16.* (M = 2^14, 64 windows): warm,
          one warm-up proof, one timed proof with every kernel's launch count
          reset just before it and read just after; the proof must verify
          and tampered proofs must not; one more proof, from the timed
          proof's rng state, reports seconds per phase (synchronized at each
          phase) with ZKMEMBER_TRACE=1 and stderr captured (traced_proof:
          its lines parse, its phases are the table route's and add up to
          90-100 % of its wall time, its msm_all line has 0 <
          mfu_vs_imad_peak <= 1.05, and it equals the timed proof and
          verifies); one more proof holds the first
          kernel call of every distinct shape against its plain version on
          the same inputs (K2's shapes and launches must match the table
          phase k2 timed, and no K2 operand may be copied); then K1 and the
          finish are timed at the proof's shapes on the checked proof's
          inputs, beside that run's plain times (a proof is prove_batch of
          one: K1's digits are (W, 1, R, B))
  options prove_lm's key options on the committed key: precompute=False,
          merge_bool=False (the boolean witness class split out, summed by
          masked lane reductions on K2; every MSM's table built on the fly):
          a warm-up and a timed proof (launches counted), equal to the
          table-route proof from the same rng state, verified, tampered ones
          rejected; phases; one more proof under checked_run (K2 at the
          per-call table builds and the boolean reductions, K1 and the
          finish over the per-call tables); window_sums over the G1 rows
          under checked_run, its Horner join equal to msm_program's; K1, the
          finish and K2 timed at the new shapes
  multi   multi-device proving over torch.distributed, NCCL with one rank a
          card (world size 1 on one card: every collective still a real NCCL
          call): entry.dryrun_multi; then, in one run_ranks world, the
          committed key's proof with every MSM sharded (prove_lm.prove(mesh=)),
          for a key built with min_lanes = D (K1 over each rank's block of
          its kept tables) and for the options key (tables on the fly): warm
          (warm_sharded), a warm-up and a timed proof (launches and
          collectives counted, the collectives' time), equal to the
          single-device proof from the same rng state, verified, tampered
          ones rejected, phases, one more proof under checked_run; K1 and the
          finish timed at its shapes; sharded_ntt at N = 2^14 against
          ntt.ntt and sharded_two_to_one over 1,024 pairs against
          two_to_one_device (limb for limb), the Jacobian sharded_msm over
          1,024 points against a host MSM and sharded_field_sum over 2^9
          terms against Python integers, each under checked_run (K3 held at
          every shape), K3 timed at the MSM's rows and the four-step NTT's
          twiddle product; then, in this process, the sharded route's combine
          for D = 2, 4 and 8 (the G1 rows split into D lane blocks, the local
          half on each over its block of the kept table and over a table
          built on the fly, the combine over the stacked (W, R, n, NT) K1
          sums) equal limb for limb to the unsharded MSM, under checked_run
          (K1 at each block, K2 at each block's table, the finish), K1 and
          the finish timed at those shapes
  k3      batch-major Montgomery-product kernel against its plain version,
          bit for bit, at n = 16, 24 and 48 (random rows, the rows 0, 1 and
          p - 1, a broadcast (n,) operand) for both stacks' fields, then
          timed at the v1 path's shapes and at BW6-761's fixed-base wave
          (n = 48) beside its plain version (ms, device_ms, host_us)
  setup   Groth16 setup of the 16-member circuit on the card, with the rng
          that made the committed key: all twelve query arrays of
          artifacts/groth16_bls12_381_16.npz, beta/delta, the vk and the
          index lists of its json must come out equal
  prove_v1  the v1 (batch-major) prover on those keys: one warm-up proof,
          one timed proof with the launch counts reset just before it and
          read just after (K3 only), one proof with phase times, traced as
          in `prove` (the v1 prover prints no msm_all line, as the
          reference's); the proof verifies, tampered ones do not, and it
          equals the limb-major
          prover's proof from the committed key with the same rng state;
          one more proof holds the first K3 call at every distinct operand
          shape against the plain version (no K3 operand may be copied)
  cli     python -m zkmember_tpu_torch.app.cli in subprocesses: register 16
          members (15 through `interactive`, one through `register`),
          `root`, `prove` (inline verification true), `verify` (exit 0) and
          `verify` against another member's leaf (exit 1)
  prove_batch  prove_lm.prove_batch from the committed key over distinct
          members of the 16-member registrar: a batch of 4 must equal 4
          sequential prove calls with the same rng state, every proof must
          verify and fail for another member's leaf, and one more batch holds
          every kernel call against its plain version (K1 with P = 4, the
          finish over P x R rows, K2 at the batched shapes, no copy); batches
          of 4 and 8 are timed (3 runs, launch counts reset before the first)
          beside one proof of the same process, with phases; then K1 and the
          finish are timed at both batches' shapes beside their plain versions
  harness python -m zkmember_tpu_torch.app.bench_harness --sizes 16
          --checkpoint-dir artifacts --reps 3, then the same with --batch 4, in
          subprocesses: the rows parse, verify is true, artifacts/ is unchanged
  bench   python3 bench_cuda.py in a subprocess as users run it (16 members,
          the committed key): its last stdout line has bench.py's keys and
          metric plus the card line, value > 0, stderr shows the key load and
          both `# [warm]` lines, artifacts/ is unchanged; then
          bench_cuda.main at 64 members, whose key the card's copy lacks:
          setup on the card into a temporary directory (K3, K2, K1 and the
          finish launched, the proof verified), a second run over that
          directory loads the key and writes nothing (no K3); then setup from
          the rng state that made the committed 64-member key reproduces its
          12 query arrays (SHA-256 digests), vk, beta_g1 and delta_g1
  bench_sweep (optional, not in the defaults) bench_cuda.main at each of
          bench.py's sizes (16, 50, 64, 100, 128, 512, 1,000, 1,024 members),
          setup into a temporary directory where the card's copy lacks the
          key: one {"bench_sweep": ...} stdout line a size (value, setup_s,
          M, launches)
  hash    Pedersen hashing and Merkle levels on the card, both stacks
          (pedersen381: Jubjub over BLS12-381 Fr, n = 16; pedersen761: n = 24):
          Member.hash_batch over 1,024 members, then the membership tree
          (eleven levels) with the device backend, once under checked_run
          (K3 held against its plain version at every distinct shape: each
          te_add wave of each round, the Fermat inverse's rows, from_mont)
          and twice timed with the launch counts reset just before and read
          just after (K3 only); a checked 64-leaf tree equal to the host
          tree; at pedersen381 the 1,024-leaf tree and every member's digest
          also on the host, timed and equal; at pedersen761 64 members
          against host Member.hash; entry() on the card equal to
          two_to_one_host; the 1,024-member proof in this process
          (bench_harness._build on the card; setup at M = 2^15, the table
          build and one proof under checked_run, so K3, K2, K1 and the
          finish are held at every shape of that path; one more proof with
          its launches counted; both verify, tampered ones do not); then
          the bench harness's Groth16 grid at 1,024 members in a
          subprocess (setup on the card, a proof that verifies); K3 timed at the widest te_add wave (5, 1024, 128,
          n) and the inverse's (1024, n) rows
  scale   app.scale.run_depth(32): the depth-32 circuit (100,005 constraints,
          M = 2^17) traced, set up on the card, warmed, proved twice and
          verified, with the launches of each phase (counts reset at each
          row); the proof fails for a wrong leaf; one more proof holds every
          kernel call against its plain version; K1 and the finish timed at
          its shapes; a precompute=False proof (the on-the-fly route) equal
          to the table route's; msm_program_chunked over the G1 rows in 4
          slices of 2^15 lanes equal to one unsliced MSM, K1 and the finish
          timed at the slice; the allocator's peak around a build of the G1
          table and around a table-route proof (straus.table_budget's basis)
  bw6     the pedersen761 stack (Groth16 over BW6-761, Fq of 48 limbs for G1
          and G2): the 16-member registrar and circuit (20,761 constraints,
          M = 2^15); setup on the card; the key saved and loaded back; warm,
          a warm-up and a timed prove_lm proof (launch counts reset just
          before it: K2, and K1 and the finish at n = 48 only); verify and
          the tampered proofs; phases, traced as in `prove` (its msm_all
          line counts G2 over Fq at n = 48); a checked table build (K2 at n = 48)
          and a checked proof (K2 at n = 24, K1 and the finish at n = 48 for
          G1 and G2, no copies); the v1 proof equal to prove_lm's, and one
          more v1 proof with K3 held at every distinct shape; a batch of 4
          equal to 4 sequential proofs, each bound to its leaf; K1 and the finish timed at the
          proof's shapes and at P = 4; the bench harness (--stack
          pedersen761, the saved key) and the CLI on 4 members in
          subprocesses
  marlin  Marlin over KZG: the 16-member BLS12-381 registrar of `prove`
          (|H| = 2^14, |K| = 2^15, SRS degree 196,608 in 13 table rows of
          16,384 lanes): universal setup (K3), index (the SRS table on K2,
          NTTs on K2, the matrix commitments on K1 and the finish), a first
          proof, a timed one with the launch counts reset just before it
          and read just after (K2 at every NTT stage, K1 and the finish
          once per round and once for the openings, nothing else; K1 and
          the finish counted by shape, the launches the kernels line gives
          each shape), a proof
          with phases; it verifies, and a wrong root and another member's
          leaf are rejected; another rng gives other w_hat and z_A
          commitments; one more setup, index and proof hold the first call
          of every kernel at each distinct shape against its plain version
          (the SRS and commitments must come out the same, K2's shapes
          must match marlin_k2_shapes); K1 and the finish timed at each
          commit shape, K2 at each NTT shape, K3 at setup's wave; a warm
          proof with the KZG lane budget below D + 1 (no SRS table: each
          commitment through msm_program; launches counted by shape),
          equal to the table route's proof and commitments, K1 and the
          finish timed at each of its shapes; then the
          pedersen761 registrar of MARLIN_BW6_MEMBERS members (K1 and the
          finish at n = 48) set up, indexed, proved, verified, tampered
          and checked, K1 and the finish timed at its commit shapes; then
          the bench harness's --systems marlin and
          --universal runs in subprocesses (rows parse, verify true)
  profile (optional, last) one more run of each prover path that ran
          (prove, prove_batch at 8 proofs, scale, bw6, prove_v1, hash, marlin) under
          torch.profiler: the kernels' device time, the device's idle
          share, the top kernels

Progress goes to stderr; the bench phases' in-process bench_cuda.main runs print
their own result lines to stdout as they go.  stdout ends with a prove line, an options line, a
multi line (the sharded proof), a setup/prove_v1 line, a prove_batch/harness/scale line, a BW6-761 line, a bench line, a hash line, a
Marlin line, a
trace line (the three traced proofs: each one's msm_all line, null for the
v1 prover, its wall time and the sum of its phases), the card line
(nvidia-smi), one JSON "kernels" line and, last, {"ok": true, "device":
...}.  Every bound_ms comes from the card's model in
zkmember_tpu_torch/utils/obs.py.
Imports nothing of JAX.  Needs one CUDA card; without one it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

T0 = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))

# Bounds come from the card's model in zkmember_tpu_torch/utils/obs.py (the
# H100's peaks, the IMADs of a Montgomery product, K1's and the finish's
# bytes and IMADs); operands of a field-product timing within its L2_BYTES
# are read from L2 on repeated calls (in_l2 marks them).
HOLD_CYCLES = 5_000_000  # about 3 ms of spinning at the H100's clocks

RESULTS: dict = {}
STATE: dict = {}  # keys and circuits handed from one phase to the next
CIRCUITS: dict = {}  # (stack, members) -> the registrar (and the rng state after its CRH
# params); ("circuit", stack, members) -> bench.py's circuit and its public inputs
PEOPLE: dict = {}  # (stack, members) -> the registrar's members (each carries its join time)
# prove_lm's path
PROVE_M = 1 << 14  # the domain of the 16-member circuit's committed key
PROVE_KERNELS = ("mont_mul", "select_reduce_fp", "select_reduce_fp2", "msm_finish_fp",
                 "msm_finish_fp2")
# the BW6-761 stack's: K1 and the finish at n = 48 (Fp, both groups); K2 as above
BW6_KERNELS = ("select_reduce_fp48", "msm_finish_fp48")
BW6_M = 1 << 15  # the domain of the 16-member BW6-761 circuit
MARLIN_BW6_MEMBERS = 4  # the BW6-761 Marlin run's registrar
ERRS: dict = {}  # kernel -> largest limb difference from its plain version
CHECKS: dict = {}  # kernel -> the shapes at which it was held against it
MSM_TIMES: list = []  # K1 and the finish timed at each path's shapes, one entry a group
MSM_REPS = 5  # calls a round when K1 or the finish is timed: each takes 2-170 ms
# (kernel, input shape) -> the plain time and the inputs of the first call that
# checked_run held at that shape in the current phase: time_k1_finish times the
# kernel on those inputs instead of running the slow plain version again
PLAIN_RUNS: dict = {}
TRACES: list = []  # one entry a traced proof (traced_proof): its msm_all line, wall, phases
# the phase names of a traced proof, in order, on prove_lm's table route and the v1 prover
LM_PHASES = ("matrix_evals", "h_pipeline", "witness_planes", "g1_select_reduce", "g1_finish",
             "g2_select_reduce", "g2_finish", "fetch", "assemble")
V1_PHASES = ("matrix_evals", "h_kernel", "h_to_host", "msm_a", "msm_b1", "msm_b2", "msm_h",
             "msm_l", "assemble")


def log(msg: str) -> None:
    print(f"# [{time.time() - T0:8.2f}s] {msg}", file=sys.stderr, flush=True)


def cuda_ms(fn, reps: int = 20, rounds: int = 3, warmup: bool = True) -> float:
    """Milliseconds of one fn() on the card: `reps` back-to-back calls between
    one pair of CUDA events, divided by `reps`; the median of `rounds`."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def plain_timed(fn):
    """fn()'s result and the milliseconds of that one call on the card
    (between CUDA events): a plain version is run once, for both its check
    and its time."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, reps: int = 20, rounds: int = 3) -> float:
    """Milliseconds of one fn() on the card alone: as cuda_ms, but the card
    is held busy (a spin kernel of HOLD_CYCLES) while the host queues the
    `reps` calls, so the events time the card, not the host's queueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int = 200, rounds: int = 3) -> float:
    """Microseconds of host time to queue one fn(): the host clock around
    `reps` back-to-back calls (no synchronization inside), divided by `reps`;
    the median of `rounds`."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def rand_planes(np_rng, spec, shape):
    """Random (K, n, B) int32 planes of values in [0, p) with 0 and p - 1 in
    lanes 0 and 1."""
    import numpy as np
    import torch

    K, n, B = shape
    limbs = np_rng.integers(0, 1 << 16, size=(K, n, B), dtype=np.int64)
    limbs[:, n - 1, :] %= int(spec.p_limbs[-1])  # top limb below p's: value < p
    limbs[:, :, 0] = 0
    pm1 = spec.p_limbs.astype(np.int64).copy()
    pm1[0] -= 1
    limbs[:, :, 1] = pm1
    return torch.as_tensor(limbs, dtype=torch.int32, device="cuda")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    import bench_cuda

    name = torch.cuda.get_device_name(0)
    smi = bench_cuda.device_label(torch.device("cuda"))
    RESULTS["device"] = name
    RESULTS["smi"] = smi
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")


def phase_build():
    from zkmember_tpu_torch import kernels

    t = time.time()
    kernels.library()
    RESULTS["build_s"] = time.time() - t
    log(f"kernels built and loaded in {RESULTS['build_s']:.1f}s")
    for line in kernels.BUILD_LOG.splitlines():
        if any(k in line for k in ("registers", "spill", "Function properties")) \
                or line.startswith("=="):
            print(f"#   {line.strip()}", file=sys.stderr)
    RESULTS["finish_ptxas"] = finish_ptxas(kernels.BUILD_LOG)
    for r in RESULTS["finish_ptxas"]:
        log(f"finish kernel {r['kernel']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} B, loads {r['spill_loads']} B")


def finish_ptxas(build_log: str) -> list:
    """Registers and spill bytes of the finish's kernels (tail and join, each
    variant) from ptxas -v in the build log; empty where this process did
    not build the library."""
    import re

    out, keep, cur = [], False, None
    for line in build_log.splitlines():
        if line.startswith("=="):
            keep = "msm_finish" in line
        elif keep and "Compiling entry function" in line:
            kind = "tail" if "tail_kernel" in line else "join" if "join_kernel" in line else None
            m = re.search(r"FinishFieldILi(\d+)ELi(\d+)E", line)
            cur = None
            if kind and m:
                n, c = 2 * int(m.group(1)), int(m.group(2))
                cur = {"kernel": f"{kind} {'fp2' if c == 2 else 'fp'} n={n}"}
        elif cur is not None and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(cur)
            cur = None
    return out


def _finish_split(fn, waves: int | None = None, calls: int = 3) -> dict:
    """Device milliseconds a call of each of the finish's two kernels
    (tail_kernel, join_kernel) under torch.profiler over `calls` calls of
    fn, the finish launched in turn (msm_finish_in_turn: the tail to its
    end, then the join, so neither waits on the other), and the join's
    microseconds a wave where `waves` (derived from the shape) is given.
    None where three windows recorded neither."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for _ in range(3):  # a window now and then records no kernel in a long run
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {"tail_ms": 0.0, "join_ms": 0.0}
        for e in prof.key_averages():
            for key in ("tail", "join"):
                if f"{key}_kernel" in e.key:
                    split[f"{key}_ms"] += dev_us(e) / 1e3 / calls
        if split["tail_ms"] > 0 and split["join_ms"] > 0:
            if waves:
                split["wave_us"] = split["join_ms"] * 1e3 / waves
            return split
    return {"tail_ms": None, "join_ms": None, "wave_us": None}


def phase_k2(np_rng):
    from zkmember_tpu_torch.fields import lm_cuda, spec as fs

    for spec, shape in ((fs.BLS_FQ, (3, 24, 65536)), (fs.BLS_FR, (3, 16, 16384)),
                        (fs.BW6_FQ, (3, 48, 1024))):
        a = rand_planes(np_rng, spec, shape)
        b = rand_planes(np_rng, spec, shape)
        got = lm_cuda.mont_mul_cuda(spec, a, b)
        want = lm_cuda.mont_mul_plain(spec, a, b)
        _hold("mont_mul", f"{spec.name} {shape}", got, want)
        log(f"K2 mont_mul {spec.name} {shape}: bit-exact against the plain version")
    RESULTS["mont_mul_shapes"] = time_k2(np_rng, k2_proof_shapes(PROVE_M), PROVE_M)
    RESULTS["mont_mul"] = RESULTS["mont_mul_shapes"][0]  # the shape of most launches


def k2_proof_shapes(M: int, P: int = 1, fr=None) -> dict:
    """K2's operand shapes in one prove_lm batch of P proofs (a proof is a
    batch of one) of domain size M over the scalar field `fr` (default
    BLS12-381 Fr), each with its launches: the H pipeline of ntt/lm.py (the
    prove, prove_batch and bw6 phases check this table against the proofs'
    own calls)."""
    from zkmember_tpu_torch.fields import spec as fs

    fr = fr or fs.BLS_FR
    f, n, h, log_m = fr.name, fr.n, M // 2, M.bit_length() - 1
    return {
        (f, (P, 3, n, h), (n, h)): 2 * log_m,  # the stages of the stacked iNTT and coset NTT
        (f, (P, n, h), (n, h)): log_m,  # the stages of the coset iNTT
        (f, (P, 3, n, M), (n, 1)): 1,  # 1 / N
        (f, (P, 3, n, M), (n, M)): 1,  # the coset scale g^i
        (f, (P, n, M), (P, n, M)): 1,  # A B
        (f, (P, n, M), (n, M)): 1,  # the coset scale g^-i / N
        (f, (P, n, M), (n, 1)): 2,  # 1 / Z_H; out of Montgomery form
    }


def _host_points(curve, gen, count, rng):
    """count distinct pseudo-random points: P_0 = a G, P_i = P_(i-1) + b G."""
    P = curve.mul(rng.randrange(1, 1 << 255), gen)
    step = curve.mul(rng.randrange(1, 1 << 255), gen)
    pts = []
    for _ in range(count):
        pts.append(P)
        P = curve.add(P, step)
    return pts


def _planes_of(spec, pts, g2: bool):
    import numpy as np
    import torch

    def dev(vals):
        arr = spec.to_mont_host(vals).T.astype(np.int64)
        return torch.as_tensor(arr, dtype=torch.int32, device="cuda")

    if g2:
        X = tuple(dev([p[0].coeffs[i].v for p in pts]) for i in range(2))
        Y = tuple(dev([p[1].coeffs[i].v for p in pts]) for i in range(2))
    else:
        X = dev([p[0].v for p in pts])
        Y = dev([p[1].v for p in pts])
    return X, Y


def _to_numpy(c):
    if isinstance(c, tuple):
        return tuple(_to_numpy(ci) for ci in c)
    return c.cpu().numpy()


def _flat(S):
    if isinstance(S, tuple):
        return [c for x in S for c in _flat(x)]
    return [S]


def _hold(name, where, got, want):
    """Raise unless a kernel's output equals its plain version's limb for
    limb; record the largest difference and the shape for the kernels line."""
    g, w = _flat(got), _flat(want)
    if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
        raise AssertionError(f"{name} at {where}: output shapes differ from the plain version's")
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0 for a, b in zip(g, w))
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version at {where}: "
                             f"max limb error {err}")
    ERRS[name] = max(ERRS.get(name, 0), err)
    CHECKS.setdefault(name, []).append(where)
    return err


def _cat_windows(parts):
    import torch

    if isinstance(parts[0], tuple):
        return tuple(_cat_windows(list(p)) for p in zip(*parts))
    return torch.cat(parts, 0)


def select_reduce_plain_sliced(ops, tab, digits, lanes: int = 8 * 4 * (1 << 14)):
    """The plain select+reduce over window slices of about `lanes` selected
    lanes each (8 windows of the 16-member G1 MSM), joined on the window
    axis: the whole grid's temporaries do not fit the card."""
    import math

    from zkmember_tpu_torch.msm import select_reduce_cuda as k1

    W = digits.shape[0]
    step = max(1, lanes // math.prod(digits.shape[1:]))
    return _cat_windows([k1.select_reduce_plain(ops, tab, digits[w : w + step])
                         for w in range(0, W, step)])


def phase_k1(np_rng, py_rng):
    """K1 and the finish on random points, every variant: BLS12-381 G1 (Fp,
    n = 24) and G2 (Fp2) at the proof's 64 windows, BW6-761 G1 (b3 = -3) and
    G2 (b3 = 12), both Fp at n = 48, at its 95 windows."""
    import numpy as np
    import torch

    from zkmember_tpu_torch.curves import bls12_381 as bls, bw6_761 as bw6
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.msm import finish_cuda as fin, select_reduce_cuda as k1, straus
    from zkmember_tpu_torch.snark import groth16, prove_lm

    B = 4096
    for curve_name, mod, W in (("bls12_381", bls, 64), ("bw6_761", bw6, 95)):
        cfg = groth16.pairing_config(curve_name)
        for g2 in (False, True):
            ops = prove_lm.sw_ops(cfg, g2, "cuda")
            curve, gen = (mod.G2, mod.G2_GEN) if g2 else (mod.G1, mod.G1_GEN)
            fp2 = g2 and cfg.g2_fp2
            X, Y = _planes_of(cfg.fq_spec, _host_points(curve, gen, B, py_rng), fp2)
            tab = straus.table_program(ops, X, Y)  # records (16, 1, B, .)
            scal = [py_rng.randrange(mod.R) for _ in range(B)]
            z = torch.as_tensor(fs.to_lm(fs.ints_to_limbs(scal, cfg.fr_spec.n)).astype(np.int64),
                                dtype=torch.int32, device="cuda")
            digits = straus.digits_from_limbs(z, W)[:, None].contiguous()  # (W, 1, B)
            got = k1.select_reduce_cuda(ops, tab, digits)
            want = k1.select_reduce_plain(ops, tab, digits)
            name = k1.variant("select_reduce", fp2, cfg.fq_spec.n)
            where = f"{curve_name} {'G2' if g2 else 'G1'} b3={ops.b3} random points W={W} R=1 B={B}"
            _hold(name, where, got, want)
            fname = name.replace("select_reduce", "msm_finish")
            NT = got[0][0].shape[-1] if fp2 else got[0].shape[-1]
            _hold(fname, f"K1's output {where} NT={NT}", fin.msm_finish_cuda(ops, got),
                  fin.msm_finish_plain(ops, got))
            sg, sw = (tuple(straus._map_coord(lambda c: c[:, 0], x) for x in S)
                      for S in (got, want))
            pts = [straus.projective_to_host(curve, _to_numpy(acc))  # (W, n, NT): no row axis
                   for acc in (fin.msm_finish_cuda(ops, sg), fin.msm_finish_plain(ops, sw))]
            if pts[0] is None or any(p != pts[0] for p in pts):
                raise AssertionError(f"K1 {name} and the finish give another point than the "
                                     f"plain versions at {where}")
            log(f"K1 {name} and {fname} at {where} (NT={NT}): limb-exact, the same point")


def _registrar(members: int, stack: str = "pedersen381", people=None):
    """The mock registrar of `members` on a curve stack, built as bench.py and
    bench_cuda.py build it (once per run; bench_cuda.membership_tree): its
    CRH parameters, leaf digests and tree, and the rng's state after the
    parameters (what the bench's setup finds).  people: the members to take,
    where another process built the registrar (a member's digest covers its
    join time)."""
    if (stack, members) not in CIRCUITS:
        import bench_cuda
        from zkmember_tpu_torch.app import circuits as app
        from zkmember_tpu_torch.app.member import generate_members
        from zkmember_tpu_torch.utils import rng as frng

        t = time.time()
        rng = frng.test_rng()
        cfg = app.get_config(stack)
        leaf_params, node_params = cfg.setup_params(rng)
        people = PEOPLE.setdefault((stack, members), people or generate_members(members))
        digests, tree = bench_cuda.membership_tree(leaf_params, node_params, people)
        CIRCUITS[stack, members] = (cfg, leaf_params, node_params, digests, tree, rng.getstate())
        log(f"{members}-member {stack} registrar built in {time.time() - t:.1f}s")
    return CIRCUITS[stack, members]


def _member_circuit(members: int, idx: int, stack: str = "pedersen381"):
    """Member idx's membership circuit and its public inputs (root, leaf):
    bench_cuda.member_circuit over the registrar."""
    import bench_cuda

    return bench_cuda.member_circuit(*_registrar(members, stack)[:5], idx)


def _membership_circuit(members: int, stack: str = "pedersen381"):
    """The bench's circuit, the proof of its member (bench_cuda.member_index)
    of the registrar (built once per run), and a fresh rng in the state the
    bench's setup finds."""
    import bench_cuda

    key = ("circuit", stack, members)
    if key not in CIRCUITS:
        CIRCUITS[key] = _member_circuit(members, bench_cuda.member_index(members), stack)
    cs, public = CIRCUITS[key]
    return cs, public, _rng_at(_registrar(members, stack)[-1])


def phase_prove(np_rng):
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    cs, public, rng = _membership_circuit(16)
    log(f"circuit: {cs.num_constraints} constraints, {cs.num_variables} vars")
    ck = os.path.join(REPO, "artifacts", "groth16_bls12_381_16")
    keys = checkpoint.load_groth16_keys(ck, device="cuda")
    log(f"keys loaded: M={keys.M}, G1 lanes 4x{keys.B1}, G2 lanes {keys.B2g}, {keys.nwin} windows")
    t = time.time()
    prove_lm.warm(keys)
    log(f"warm (kernels + Straus tables) in {time.time() - t:.1f}s")
    t = time.time()
    prove_lm.prove(keys, cs, rng=rng)
    log(f"warm-up proof in {time.time() - t:.2f}s")

    state = rng.getstate()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    proof = prove_lm.prove(keys, cs, rng=rng)
    prove_s = time.time() - t
    launches = dict(kernels.LAUNCHES)
    log(f"timed proof in {prove_s:.3f}s; launches {launches}")
    missing = [k for k in PROVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the proof launched no {missing}")
    # the H pipeline's 3 log2(M) NTT stages and 6 pointwise products; one K1
    # and two finish launches per MSM
    expect = {"mont_mul": 3 * (keys.M.bit_length() - 1) + 6, "select_reduce_fp": 1,
              "select_reduce_fp2": 1, "msm_finish_fp": 2, "msm_finish_fp2": 2}
    if any(launches[k] != v for k, v in expect.items()):
        raise AssertionError(f"the proof's launches {launches} differ from {expect}")
    RESULTS["prove_s"] = prove_s
    RESULTS["launches"] = launches
    STATE.update(keys=keys, cs=cs, rng=rng)
    # the timed proof's rng state once more, traced (the trace synchronizes at each phase)
    RESULTS["breakdown"] = traced_proof(
        lambda phases: prove_lm.prove(keys, cs, rng=_rng_at(state), phase_times=phases),
        "proof", LM_PHASES, proof, keys.pk.vk, public)
    log("phases of a proof synchronized at each phase: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in RESULTS["breakdown"].items()))

    _holds_and_tamper_fails(keys.cfg, keys.pk.vk, public, proof, "proof")
    _, k2_shapes, *_ = checked_run(lambda: prove_lm.prove(keys, cs, rng=rng), "proof")
    if sum(k2_shapes.values()) != launches["mont_mul"]:
        raise AssertionError(f"the checked proof's K2 calls {k2_shapes} differ from the timed proof's")
    if k2_shapes != k2_proof_shapes(keys.M):
        raise AssertionError(f"the proof's K2 shapes {k2_shapes} differ from the table "
                             f"{k2_proof_shapes(keys.M)} that phase k2 times")
    # K1 and finish times at the proof's shapes, each beside its plain version
    # (phase k2 times K2 at the proof's shapes)
    time_msm_kernels(np_rng, keys, 1, "proof", launches)


def _scalars_on_points(np_rng, fr, X, Y):
    """Random canonical scalar limbs (..., nl, B) for the affine planes
    (X, Y) (..., n, B) of a key's rows, zero on the padded lanes, whose (0, 0)
    is no curve point: the complete law holds only for curve points."""
    import math

    shape = tuple(X.shape)
    lead, B = shape[:-2], shape[-1]
    z = rand_planes(np_rng, fr, (math.prod(lead), fr.n, B)).reshape(lead + (fr.n, B))
    on_curve = ((X != 0) | (Y != 0)).any(dim=-2, keepdim=True)
    return z * on_curve


def phase_options(np_rng):
    """prove_lm's key options on the committed 16-member key: a key with
    precompute=False and merge_bool=False (rebuilt from the checkpoint's
    ProvingKey; the boolean witness class split out with the circuit's
    boolean variables); a warm-up and a timed proof with the launch counts
    reset just before it and read just after (K2, and K1 and the finish
    once per MSM family); the proof equals the table route's from the same
    rng state, verifies, and fails tampered; one more proof under
    checked_run (the per-call table builds and the boolean tree reductions
    on K2, K1 and the finish over the per-call tables); window_sums over
    the key's G1 rows under checked_run, its Horner join equal to
    msm_program's; K1 and the finish timed on the checked proof's inputs,
    K2 at each of its shapes that a table-route proof does not have."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.snark import prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    cs, public, _ = _membership_circuit(16)
    state = _registrar(16)[-1]
    base = STATE.get("keys") or checkpoint.load_groth16_keys(
        os.path.join(REPO, "artifacts", "groth16_bls12_381_16"), device="cuda")
    out: dict = {}
    t = time.time()
    keys = prove_lm.Groth16KeysLM(base.pk, "cuda", cs=cs, precompute=False, merge_bool=False)
    prove_lm.warm(keys)
    out["keys_s"] = time.time() - t
    if keys.g1_tab is not None or keys.g2_tab is not None or not keys.has_bool:
        raise AssertionError("the options key keeps a table or has no boolean class")
    out.update(M=keys.M, B1=keys.B1, Bb=keys.Bb, B2g=keys.B2g, B2b=keys.B2b,
               booleans=len(cs.boolean_vars),
               bool_lanes=[len(c) for c in keys.bool_cols] + [len(keys.b_bool_cols)])
    log(f"options key in {out['keys_s']:.2f}s: G1 4x{keys.B1} general and 3x{keys.Bb} boolean "
        f"lanes {out['bool_lanes'][:3]}, G2 {keys.B2g} general and {keys.B2b} boolean lanes "
        f"({out['bool_lanes'][3]}), no table")
    t = time.time()
    prove_lm.prove(keys, cs, rng=_rng_at(state))
    out["first_prove_s"] = time.time() - t

    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    proof = prove_lm.prove(keys, cs, rng=_rng_at(state))
    out["prove_s"] = time.time() - t
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    log(f"options: warm-up proof {out['first_prove_s']:.3f}s, timed proof {out['prove_s']:.3f}s; "
        f"launches {launches}")
    want = {"select_reduce_fp": 1, "select_reduce_fp2": 1, "msm_finish_fp": 2, "msm_finish_fp2": 2}
    if {k: launches.get(k, 0) for k in want} != want or set(launches) != set(want) | {"mont_mul"}:
        raise AssertionError(f"the options proof launched {launches}")
    out["launches"] = launches
    if not _same_proof(proof, prove_lm.prove(base, cs, rng=_rng_at(state))):
        raise AssertionError("the options proof differs from the table route's")
    log("options: the proof equals the table-route proof from the same rng state")
    _holds_and_tamper_fails(keys.cfg, keys.pk.vk, public, proof, "options proof")
    phases: dict = {}
    t = time.time()
    prove_lm.prove(keys, cs, rng=_rng_at(state), phase_times=phases)
    out["breakdown"] = {"total_s": time.time() - t, **phases}
    log("options phases of a proof synchronized at each phase: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in out["breakdown"].items()))

    checked, k2_shapes, k1_shapes, *_ = checked_run(
        lambda: prove_lm.prove(keys, cs, rng=_rng_at(state)), "options proof")
    if not _same_proof(checked, proof):
        raise AssertionError("the checked options proof differs from the timed one")
    if sum(k2_shapes.values()) != launches["mont_mul"]:
        raise AssertionError(f"the checked options proof's K2 calls {k2_shapes} differ from "
                             "the timed proof's")
    h_shapes = k2_proof_shapes(keys.M)
    if any(k2_shapes.get(k, 0) < v for k, v in h_shapes.items()):
        raise AssertionError(f"the options proof's K2 calls {k2_shapes} miss the H pipeline's")
    new = {k: v for k, v in k2_shapes.items() if k not in h_shapes}
    out["k2_new_shapes"] = [[f, list(a), list(b), v] for (f, a, b), v in new.items()]
    out["k1_shapes"] = [[list(k), v] for k, v in k1_shapes.items()]

    # window_sums over the key's G1 rows on random scalars, held against
    # its plain version; its Horner join equals msm_program's point, row for row
    z = _scalars_on_points(np_rng, fs.BLS_FR, keys.g1_X, keys.g1_Y)
    S, ws_k2, ws_k1, *_ = checked_run(
        lambda: straus.window_sums(keys.ops1, keys.g1_X, keys.g1_Y, z, keys.nwin),
        "options window sums")
    if tuple(S[0].shape) != (keys.nwin, 4, fs.BLS_FQ.n, 1):
        raise AssertionError(f"window_sums gave {tuple(S[0].shape)}")
    joined = _to_numpy(straus.horner_join(keys.ops1, S))
    direct = _to_numpy(straus.msm_program(keys.ops1, keys.g1_X, keys.g1_Y, z, keys.nwin))
    g1 = keys.cfg.mod.G1
    for r in range(4):
        a, b = (straus.projective_to_host(g1, tuple(c[r] for c in P)) for P in (joined, direct))
        if a is None or a != b:
            raise AssertionError(f"window_sums' Horner join differs from msm_program at row {r}")
    out["window_sums"] = {"k1_shapes": [list(k) for k in ws_k1],
                          "k2_launches": sum(ws_k2.values())}
    log("options: window_sums over the G1 rows held against its plain version; its Horner "
        "join equals msm_program row for row")

    time_msm_kernels(np_rng, keys, 1, "options proof", launches)
    # K2 timed at the new shapes of 256 lanes or more (the per-call table
    # waves, the widest boolean reduction levels); the narrower ones are held
    out["mont_mul_shapes"] = time_k2(
        np_rng, {k: v for k, v in new.items() if k[1][-1] >= 256}, None, "options proof")
    RESULTS["options"] = out


MULTI_POINTS = 1024  # the sharded Jacobian MSM's points and the sharded hash's pairs
MULTI_NTT = 1 << 14  # the sharded NTT's size
MULTI_SUM = 1 << 9  # the sharded field sum's terms (its max_log_terms)
COMBINE_D = (2, 4, 8)  # lane blocks of the in-process D-way combine


def phase_multi(np_rng):
    """Multi-device proving over torch.distributed on this machine's cards
    (NCCL, one rank a card; world size 1 on one card, where every
    collective is still a real NCCL call): entry.dryrun_multi; then in one
    run_ranks world the sharded proofs of the committed 16-member key
    (_multi_rank) and the sharded primitives; then the D-way combine of
    the sharded route in this process for D = 2, 4 and 8
    (_combine_on_one_card).  Every process group is destroyed by run_ranks,
    also on failure."""
    import torch

    from zkmember_tpu_torch import entry
    from zkmember_tpu_torch.parallel import dist

    n = torch.cuda.device_count()
    out: dict = {}
    t = time.time()
    out["dryrun"] = entry.dryrun_multi(n)
    out["dryrun"]["total_s"] = time.time() - t
    log(f"dryrun_multi on {n} card(s) over {out['dryrun']['backend']}: "
        f"{out['dryrun']['total_s']:.1f}s, steps {out['dryrun']['steps_s']}")
    _release_card()
    _registrar(16)  # every rank proves this registrar's circuit
    people = [m.to_json() for m in PEOPLE["pedersen381", 16]]
    res = dist.run_ranks(_multi_rank, n, args=(int(np_rng.integers(1 << 31)), people))
    if n > 1:  # rank 0 held and timed the kernels in its own process
        rec = res["records"]
        for k, v in rec["errs"].items():
            ERRS[k] = max(ERRS.get(k, 0), v)
        for k, v in rec["checks"].items():
            CHECKS.setdefault(k, []).extend(v)
        MSM_TIMES.extend(rec["msm_times"])
    out.update(res["out"])
    _release_card()
    out["combine"] = _combine_on_one_card(np_rng)
    RESULTS["multi"] = out


def _timed_collectives(run):
    """run() with each collective of parallel.dist between CUDA events:
    run()'s result and the collectives' milliseconds (packing included)."""
    import torch

    from zkmember_tpu_torch.parallel import dist

    names = ("all_gather_stack", "all_reduce_sum", "all_to_all")
    orig = {k: getattr(dist, k) for k in names}
    events = []

    def timed(fn):
        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args)
            end.record()
            events.append((start, end))
            return result

        return call

    for k in names:
        setattr(dist, k, timed(orig[k]))
    try:
        result = run()
    finally:
        for k in names:
            setattr(dist, k, orig[k])
    torch.cuda.synchronize()
    return result, sum(a.elapsed_time(b) for a, b in events)


def _multi_rank(mesh, seed: int, people: list) -> dict:
    """One rank of the multi phase: the sharded proofs of the committed key
    (a key built with min_lanes = D, then the options phase's
    precompute=False, merge_bool=False key) and the sharded primitives.
    Returns its results and the kernel records it made (held errors,
    checked shapes, K1 and finish times), which a parent process takes
    from rank 0 when the ranks are processes of their own.  people: the
    16-member registrar's members as JSON, so every rank proves the same
    circuit (a member's digest covers its join time)."""
    import numpy as np
    import torch

    from zkmember_tpu_torch.app.member import Member
    from zkmember_tpu_torch.snark import prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    np_rng = np.random.default_rng(seed)
    _registrar(16, people=[Member.from_json(m) for m in people])
    cs, public, _ = _membership_circuit(16)
    state = _registrar(16)[-1]
    base = STATE.get("keys") or checkpoint.load_groth16_keys(
        os.path.join(REPO, "artifacts", "groth16_bls12_381_16"), device=mesh.device)
    single = prove_lm.prove(base, cs, rng=_rng_at(state))  # the single-device proof
    out = {"world_size": mesh.size, "backend": torch.distributed.get_backend(),
           "mesh": mesh.shape}
    for name, opts in (("min_lanes", {}), ("options", {"precompute": False, "merge_bool": False})):
        PLAIN_RUNS.clear()
        out[name] = _sharded_proof(mesh, base, cs, public, state, single, name, opts,
                                   timed=name == "min_lanes")
    PLAIN_RUNS.clear()
    out["primitives"] = _sharded_primitives(mesh, np_rng)
    out.update(prove_s=out["min_lanes"]["prove_s"], phases_s=out["min_lanes"]["breakdown"],
               launches=out["min_lanes"]["launches"],
               collective_ms=out["min_lanes"]["collective_ms"])
    return {"out": out, "records": {"errs": dict(ERRS), "checks": dict(CHECKS),
                                    "msm_times": list(MSM_TIMES)}}


def _sharded_proof(mesh, base, cs, public, state, single, name: str, opts: dict,
                   timed: bool) -> dict:
    """The committed key's proof with every MSM sharded over `mesh`: keys
    built with min_lanes = D (and `opts`), warm_sharded, a warm-up proof, a
    timed proof with the launches and collectives counted (reset just
    before it, read just after) and the collectives' time; it equals the
    single-device proof from the same rng state, verifies, and fails
    tampered; phases; one more proof under checked_run; K1 and the finish
    timed at its shapes (`timed`)."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.parallel import dist
    from zkmember_tpu_torch.snark import prove_lm

    D = mesh.shape["msm"]
    what = f"sharded {name} proof"
    r: dict = {}
    t = time.time()
    keys = prove_lm.Groth16KeysLM(base.pk, mesh.device, cs=cs, min_lanes=D, **opts)
    prove_lm.warm_sharded(keys, mesh)
    r["keys_warm_s"] = time.time() - t
    r.update(B1=keys.B1, B2g=keys.B2g, has_bool=keys.has_bool)
    if keys.has_bool:
        r.update(Bb=keys.Bb, B2b=keys.B2b)

    def prove(**kw):
        return prove_lm.prove(keys, cs, rng=_rng_at(state), mesh=mesh, **kw)

    t = time.time()
    prove()
    r["first_prove_s"] = time.time() - t
    kernels.reset_launches()
    dist.reset_collectives()
    torch.cuda.synchronize()
    t = time.time()
    proof, r["collective_ms"] = _timed_collectives(prove)
    r["prove_s"] = time.time() - t
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    r["launches"] = launches
    r["collectives"] = {k: v for k, v in dist.COLLECTIVES.items() if v}
    log(f"{what} over {mesh.shape}: keys+warm {r['keys_warm_s']:.2f}s, warm-up proof "
        f"{r['first_prove_s']:.3f}s, timed proof {r['prove_s']:.3f}s (collectives "
        f"{r['collective_ms']:.3f} ms: {r['collectives']}); launches {launches}")
    want = {"select_reduce_fp": 1, "select_reduce_fp2": 1, "msm_finish_fp": 2,
            "msm_finish_fp2": 2}
    if {k: launches.get(k, 0) for k in want} != want or set(launches) != set(want) | {"mont_mul"}:
        raise AssertionError(f"the {what} launched {launches}")
    if r["collectives"] != {"all_gather": 4 if keys.has_bool else 2}:
        raise AssertionError(f"the {what} ran the collectives {r['collectives']}")
    if not _same_proof(proof, single):
        raise AssertionError(f"the {what} differs from the single-device proof")
    log(f"{what}: equal to the single-device proof from the same rng state")
    _holds_and_tamper_fails(keys.cfg, keys.pk.vk, public, proof, what)
    phases: dict = {}
    t = time.time()
    prove(phase_times=phases)
    r["breakdown"] = {"total_s": time.time() - t, **phases}
    log(f"{what} phases: " + ", ".join(f"{k} {v:.3f}s" for k, v in r["breakdown"].items()))
    checked, k2_shapes, k1_shapes, *_ = checked_run(prove, what)
    if not _same_proof(checked, proof):
        raise AssertionError(f"the checked {what} differs from the timed one")
    if sum(k2_shapes.values()) != launches["mont_mul"]:
        raise AssertionError(f"the checked {what}'s K2 calls differ from the timed proof's")
    r["k1_shapes"] = [[list(k), v] for k, v in k1_shapes.items()]
    r["k2_shapes"] = len(k2_shapes)
    if timed:
        time_held_msm(what, launches)
    return r


def time_held_msm(where: str, launches: dict) -> None:
    """K1 and the finish timed on the inputs checked_run held them at in
    this phase (PLAIN_RUNS), beside those plain calls' times: one
    MSM_TIMES entry each, with `launches[name]` (that path's counted run)."""
    for (name, _), held in list(PLAIN_RUNS.items()):
        ops, *args = held["args"]
        group = "G2" if isinstance(ops.b3, tuple) else "G1"
        if name.startswith("select_reduce"):
            tab, dig = args
            entry = _k1_entry(ops, tab, dig, 0, held["ms"], where, group, launches[name],
                              "the checked run's")
        else:
            entry = _finish_entry(ops, args[0], 0, held["ms"], where, group, launches[name],
                                  "the checked run's")
        MSM_TIMES.append(entry)
        _log_msm_times([entry], where)


def _sharded_primitives(mesh, np_rng) -> dict:
    """The sharded NTT at MULTI_NTT against ntt.ntt, the sharded hash of
    MULTI_POINTS digest pairs against two_to_one_device (both limb for
    limb), the Jacobian sharded MSM of MULTI_POINTS points against a host
    MSM, and the field sum of MULTI_SUM terms against Python integers; each
    once, under checked_run (K3 held at every shape), its collectives
    timed."""
    import random

    import torch

    from zkmember_tpu_torch import entry
    from zkmember_tpu_torch.curves import bls12_381 as bls
    from zkmember_tpu_torch.fields import device as dv, spec as fs
    from zkmember_tpu_torch.hash import pedersen as ph
    from zkmember_tpu_torch.msm import msm
    from zkmember_tpu_torch.ntt import ntt as nttmod
    from zkmember_tpu_torch.parallel import dist

    dev = mesh.device
    fr, fq = fs.BLS_FR, fs.BLS_FQ
    node = entry._params()[2]
    rng = random.Random(int(np_rng.integers(1 << 31)))
    # points P_i = a G + i b G: the host MSM is one multiplication of G
    a, b = rng.randrange(1, bls.R), rng.randrange(1, bls.R)
    step, pt, pts = bls.G1.mul(b, bls.G1_GEN), bls.G1.mul(a, bls.G1_GEN), []
    for _ in range(MULTI_POINTS):
        pts.append(pt)
        pt = bls.G1.add(pt, step)
    scalars = [rng.randrange(bls.R) for _ in range(MULTI_POINTS)]
    k = sum(s * (a + i * b) for i, s in enumerate(scalars)) % bls.R
    host_msm = bls.G1.mul(k, bls.G1_GEN)

    def rows(vals, spec):
        return torch.as_tensor(spec.to_mont_host(vals).astype("int64"), dtype=torch.int32,
                               device=dev)

    X, Y = rows([p[0].v for p in pts], fq), rows([p[1].v for p in pts], fq)
    bits = msm.scalars_to_bits_np(scalars, bls.R.bit_length())
    coeffs = rand_rows(np_rng, fr, (MULTI_NTT, fr.n)).to(dev)
    left = rand_rows(np_rng, fr, (MULTI_POINTS, fr.n)).to(dev)  # canonical digests below r
    right = rand_rows(np_rng, fr, (MULTI_POINTS, fr.n)).to(dev)
    terms = [rng.randrange(fr.p) for _ in range(MULTI_SUM)]
    F = dv.FpOps(fq, dev)

    def jacobian_to_host(J):
        p, rinv = fq.p, pow(fq.R, -1, fq.p)
        Xj, Yj, Zj = (fs.limbs_to_int(c[0].cpu().numpy()) * rinv % p for c in J)
        zi = pow(Zj, -1, p)
        return (Xj * zi * zi % p, Yj * zi * zi * zi % p)

    cases = {
        "ntt": (lambda: dist.sharded_ntt(fr, mesh, coeffs),
                lambda got: torch.equal(got, nttmod.ntt(nttmod.Domain.get(fr, MULTI_NTT),
                                                        coeffs))),
        "hash": (lambda: dist.sharded_two_to_one(node, mesh, left, right),
                 lambda got: torch.equal(got, ph.two_to_one_device(node, left, right))),
        "msm": (lambda: dist.sharded_msm(F, mesh, bits, X, Y),
                lambda got: jacobian_to_host(got) == (host_msm[0].v, host_msm[1].v)),
        "field_sum": (lambda: dist.sharded_field_sum(fr, mesh, rows(terms, fr)),
                      lambda got: fr.from_mont_host(got.cpu().numpy())[0] == sum(terms) % fr.p),
    }
    out: dict = {}
    for name, (run, ok) in cases.items():
        torch.cuda.synchronize()
        t = time.time()
        (got, _, _, k3_counts, copied), coll_ms = _timed_collectives(
            lambda: checked_run(run, f"sharded {name}"))
        if not ok(got):
            raise AssertionError(f"the sharded {name} disagrees with its reference")
        out[name] = {"checked_s": time.time() - t, "collective_ms": coll_ms,
                     "k3_shapes": [[list(a_), list(b_), v] for (_, a_, b_), v in
                                   sorted(k3_counts.items())],
                     "k3_copied": [list(c) for c in copied]}
        log(f"sharded {name} over {mesh.shape}: equal to its reference, K3 held at "
            f"{len(k3_counts)} shapes; {out[name]['checked_s']:.3f}s checked, collectives "
            f"{coll_ms:.3f} ms")
        out[name]["k3_counts"] = k3_counts
    # K3 timed at the widest shape of the Jacobian MSM (a rank's rows) and
    # at the four-step NTT's twiddle product (a rank's N1 / D grid rows)
    D = mesh.shape["msm"]
    N1, N2 = dist.fourstep_shape(MULTI_NTT, D)
    timed = []
    for name, spec, shape in (("msm", fq, (MULTI_POINTS // D, fq.n)),
                              ("ntt", fr, (N1 // D, N2, fr.n))):
        r = time_k3(np_rng, spec, shape, shape)
        r.update(path=f"sharded {name}",
                 launches=out[name]["k3_counts"].get((spec.name, shape, shape), 0))
        timed.append(r)
    for v in out.values():
        del v["k3_counts"]
    out["k3_timed"] = timed
    return out


def _combine_on_one_card(np_rng) -> dict:
    """The sharded route's D-way combine in this process, for each D in
    COMBINE_D: the committed key's G1 rows split into D lane blocks, the
    local half (straus.sharded_window_sums) on each block, over its block
    of the kept table and over a table built on the fly from its points,
    the results stacked as the gather would, (W, R, n, NT), and
    straus.combine_window_sums over them; launches counted in one run, then
    one more under checked_run (K1 at each block, K2 at each block's table
    build and the finish held against their plain versions); each combine
    equal limb for limb to the unsharded MSM over the kept table
    (msm_precomp_program: the blocks are whole K1 tiles); K1 and the finish
    timed at those shapes."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.parallel import dist
    from zkmember_tpu_torch.utils import checkpoint

    keys = STATE.get("keys") or checkpoint.load_groth16_keys(
        os.path.join(REPO, "artifacts", "groth16_bls12_381_16"), device="cuda")
    ops, X, Y, tab = keys.ops1, keys.g1_X, keys.g1_Y, keys.g1_tab
    z = _scalars_on_points(np_rng, fs.BLS_FR, X, Y)
    whole = straus.msm_precomp_program(ops, tab, keys.nwin, z)
    out: dict = {}
    for D in COMBINE_D:
        def run():
            got = []
            for tabs in ([dist.block(tab, D, j, 2) for j in range(D)],
                         [straus.table_program(ops, *(dist.block(c, D, j, -1) for c in (X, Y)))
                          for j in range(D)]):
                S = [straus.sharded_window_sums(ops, t, dist.block(z, D, j, -1), keys.nwin)
                     for j, t in enumerate(tabs)]
                G = tuple(torch.cat([s[i] for s in S], dim=-1) for i in range(3))  # (W, R, n, NT)
                got.append(straus.combine_window_sums(ops, G))
            return got

        PLAIN_RUNS.clear()
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.time()
        run()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        r = {"s": time.time() - t, "launches": launches}
        got, _, k1_shapes, *_ = checked_run(run, f"combine D={D}")
        for route, acc in zip(("kept table", "on the fly"), got):
            if not all(torch.equal(a, b) for a, b in zip(acc, whole)):
                raise AssertionError(f"the D = {D} combine ({route}) differs from the unsharded "
                                     "MSM")
        r["k1_shapes"] = [list(k) for k in k1_shapes]
        log(f"combine D={D}: {r['s']:.3f}s, launches {launches}; both routes equal to the "
            "unsharded MSM limb for limb")
        time_held_msm(f"combine D={D}", launches)
        out[D] = r
    PLAIN_RUNS.clear()
    return out


def time_msm_kernels(np_rng, keys, P: int, where: str, launches: dict,
                     counted: dict | None = None) -> None:
    """K1 (G1 and G2) on digits of the shape a batch of P proofs over `keys`
    gives it, (W, P, R, B), and the finish on its output viewed as (W, P R,
    n, NT), as prove_lm's batched MSM does (time_k1_finish: on the inputs
    checked_run held at that shape, else random digits against the key's
    table).  Appends one entry per (kernel, group) to MSM_TIMES, with
    `path` (where) and the launches of its group in that path's timed run:
    from `counted` (``_k1_finish_launches``, by digit shape) where G1 and
    G2 run one variant (BW6-761), else from `launches` by variant."""
    if counted is None and not keys.cfg.g2_fp2:
        raise AssertionError("BW6-761's G1 and G2 share K1's variant: count them by shape")
    for group, tab, R, B in (("G1", keys._g1_tab, 4, keys.B1), ("G2", keys._g2_tab, 1, keys.B2g)):
        g2 = group == "G2"
        at = counted[(keys.nwin, P, R, B)] if counted else launches
        time_k1_finish(np_rng, keys.ops2 if g2 else keys.ops1, tab, keys.nwin, P, R, B,
                       where, group, at)


def time_k1_finish(np_rng, ops, tab, W: int, P: int, R: int, B: int, where: str, group: str,
                   launches: dict) -> None:
    """K1 on digits (W, P, R, B) against the table `tab` (its rows gathered
    to R), and the finish on K1's output viewed as (W, P R, n, NT); one
    MSM_TIMES entry each, with `launches[name]` (the launches of that
    path's timed run at this shape or group), timed with MSM_REPS
    calls a round.  Where checked_run held the kernel at that shape earlier
    in this phase (PLAIN_RUNS), it is timed on those inputs beside that
    plain call's time; otherwise on random digits, held against its plain
    version on the same inputs (that one plain call is also its time)."""
    import torch

    from zkmember_tpu_torch.msm import finish_cuda as fin, select_reduce_cuda as k1, straus

    fp2, spec, _ = k1.kernel_consts(ops)
    n = spec.n
    name = k1.variant("select_reduce", fp2, n)
    where_k1 = f"{where} W={W} P={P} R={R} B={B}"
    held = PLAIN_RUNS.get((name, (W, P, R, B)))
    if held:
        _, tab, dig = held["args"]
        plain_ms, err = held["ms"], 0
        S = k1.select_reduce_cuda(ops, tab, dig)
    else:
        if tab.shape[1] != R:
            tab = tab[:, torch.arange(R, device=tab.device) % tab.shape[1]].contiguous()
        dig = torch.as_tensor(np_rng.integers(0, 16, size=(W, P, R, B)), dtype=torch.int32,
                              device="cuda")
        S = k1.select_reduce_cuda(ops, tab, dig)
        want, plain_ms = plain_timed(lambda: select_reduce_plain_sliced(ops, tab, dig))
        err = _hold(name, where_k1, S, want)
    MSM_TIMES.append(_k1_entry(ops, tab, dig, err, plain_ms, where, group, launches[name],
                               "the checked run's" if held else "random digits"))
    # the finish on this K1 output, its P R rows as one axis: NT lanes a
    # window, then the join
    fname = k1.variant("msm_finish", fp2, n)
    NT = B // k1.tile_shape(B)[1]
    rows = P * R
    held = PLAIN_RUNS.get((fname, (W, rows, NT)))
    if held:
        Sv = held["args"][1]
        plain_ms, err = held["ms"], 0
    else:
        Sv = tuple(straus._map_coord(lambda c: c.reshape(W, rows, n, NT), x) for x in S)
        want, plain_ms = plain_timed(lambda: fin.msm_finish_plain(ops, Sv))
        err = _hold(fname, f"{where} W={W} rows={rows} NT={NT}", fin.msm_finish_cuda(ops, Sv),
                    want)
    MSM_TIMES.append(_finish_entry(ops, Sv, err, plain_ms, where, group, launches[fname],
                                   "the checked run's" if held else "random digits"))
    _log_msm_times(MSM_TIMES[-2:], where)


def _log_msm_times(entries, where: str) -> None:
    for r in entries:
        split = (f" (in turn: tail {r['tail_ms']}, join {r['join_ms']} ms, "
                 f"{r['wave_us']} us a wave of {r['waves']} from the shape)" if "waves" in r
                 else "")
        log(f"{r['name']} {r['group']} at {r['shape']} ({where}, {r['inputs']}): kernel "
            f"{r['ms']:.3f} ms{split}, plain {r['plain_ms']:.1f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]})")


def _k1_entry(ops, tab, dig, err, plain_ms, where: str, group: str, launches: int,
              inputs: str) -> dict:
    """K1 timed on records `tab` and digits (W, [P,] R, B) (MSM_REPS calls a
    round) beside its plain time, with its bound: an MSM_TIMES entry."""
    from zkmember_tpu_torch.msm import select_reduce_cuda as k1
    from zkmember_tpu_torch.utils import obs

    fp2, spec, _ = k1.kernel_consts(ops)
    n = spec.n
    W, B, R = dig.shape[0], dig.shape[-1], dig.shape[-2]
    P = dig.shape[1] if dig.ndim == 4 else 1
    NT = B // k1.tile_shape(B)[1]
    return {
        "name": k1.variant("select_reduce", fp2, n), "group": group, "path": where,
        "launches": launches, "shape": list(dig.shape), "max_abs_err": err, "inputs": inputs,
        "ms": cuda_ms(lambda: k1.select_reduce_cuda(ops, tab, dig), reps=MSM_REPS),
        "plain_ms": plain_ms,
        "bound": obs.bound(*obs.select_reduce_work(n, fp2, W, P, R, B, NT)),
    }


def _finish_entry(ops, S, err, plain_ms, where: str, group: str, launches: int,
                  inputs: str) -> dict:
    """The finish timed on window sums S, coords (W, [rows,] n, NT)
    (MSM_REPS calls a round, and its two kernels apart, in turn) beside its
    plain time, with its bound: an MSM_TIMES entry."""
    from zkmember_tpu_torch.msm import finish_cuda as fin, select_reduce_cuda as k1
    from zkmember_tpu_torch.utils import obs

    fp2, spec, _ = k1.kernel_consts(ops)
    n = spec.n
    c = _flat(S)[0]
    W, NT = c.shape[0], c.shape[-1]
    rows = c.shape[1] if c.ndim == 4 else 1
    # one row's join: 4 (W - 1) doublings and W - 1 additions, each two
    # dependent waves
    return {
        "name": k1.variant("msm_finish", fp2, n), "group": group, "path": where,
        "launches": launches, "shape": [W, rows, NT], "max_abs_err": err, "inputs": inputs,
        "ms": cuda_ms(lambda: fin.msm_finish_cuda(ops, S), reps=MSM_REPS),
        "plain_ms": plain_ms,
        "bound": obs.bound(*obs.finish_work(n, fp2, W, rows, NT)),
        "waves": 2 * 5 * (W - 1),  # from the shape: two a point operation of the chain
        **_finish_split(lambda: fin.msm_finish_in_turn(ops, S), 2 * 5 * (W - 1)),
    }


def checked_run(run, what: str):
    """run() (proofs of prove_lm or Marlin, a Marlin setup or index) with the
    first call of each kernel at every distinct shape (operand shapes and
    field) held against its plain version on the same inputs, limb for
    limb: K2 and K3 at each operand shape, K1 at each digit grid and the
    finish at each window-sum shape; no K2 operand may be copied.  Its
    launches are outside any counted run.  The plain K1 and finish calls
    are timed, and the first at each shape is kept in PLAIN_RUNS with its
    inputs for time_k1_finish.  Returns run()'s result, the
    launches of the run itself (K2's by (field, shape of a, shape of b),
    K1's by digit shape, K3's by (field, shape of a, shape of b)) and the
    sorted (field, shape of a, shape of b) of the K3 calls whose operand
    the wrapper copies before the launch (``field_cuda.launch_args`` says
    so; the kernel reads every other operand in place)."""
    from zkmember_tpu_torch.fields import field_cuda, lm_cuda
    from zkmember_tpu_torch.msm import finish_cuda as fin, select_reduce_cuda as k1

    mont_mul_cuda, select_reduce_cuda = lm_cuda.mont_mul_cuda, k1.select_reduce_cuda
    msm_finish_cuda, mont_mul_bm_cuda = fin.msm_finish_cuda, field_cuda.mont_mul_bm_cuda
    seen = set()
    counts: dict = {}  # (field, shape of a, shape of b) -> K2 launches of the run itself
    k1_shapes: dict = {}  # digit shape -> K1 launches of the run itself
    k3_counts: dict = {}  # (field, shape of a, shape of b) -> K3 launches of the run itself
    k3_copied = set()  # (field, shape of a, shape of b) of K3 calls with a copied operand
    in_plain = [0]  # the plain K1 and finish run their products on K2 too: not counted

    def mont_mul_checked(spec, a, b):
        out = mont_mul_cuda(spec, a, b)
        key = (spec.name, tuple(a.shape), tuple(b.shape))
        if key not in seen:
            seen.add(key)
            g = lm_cuda.launch_args(spec.n, a.shape, a.stride(), b.shape, b.stride())
            if g.copy_a or g.copy_b:
                raise AssertionError(f"K2 copies an operand at {key}")
            _hold("mont_mul", f"{what} {spec.name} {key[1]} x {key[2]}", out,
                  lm_cuda.mont_mul_plain(spec, a, b))
        if not in_plain[0]:
            counts[key] = counts.get(key, 0) + 1
        return out

    def mont_mul_bm_checked(spec, a, b):
        out = mont_mul_bm_cuda(spec, a, b)
        key = ("bm", spec.name, tuple(a.shape), tuple(b.shape))
        g = field_cuda.launch_args(spec.n, a.shape, a.stride(), a.data_ptr() % 16 == 0,
                                   b.shape, b.stride(), b.data_ptr() % 16 == 0)
        if g.copy_a or g.copy_b:
            k3_copied.add(key[1:])
        if key not in seen:
            seen.add(key)
            _hold("mont_mul_bm", f"{what} {spec.name} {key[2]} x {key[3]}", out,
                  mont_mul_bm_plain_rows(spec, a, b))
        k3_counts[key[1:]] = k3_counts.get(key[1:], 0) + 1
        return out

    def plain(fn, *args):
        in_plain[0] += 1
        try:
            return fn(*args)
        finally:
            in_plain[0] -= 1

    def variant(kernel, ops):
        fp2, spec, _ = k1.kernel_consts(ops)
        return k1.variant(kernel, fp2, spec.n)

    def select_reduce_checked(ops, tab, digits):
        out = select_reduce_cuda(ops, tab, digits)
        key = tuple(digits.shape)
        k1_shapes[key] = k1_shapes.get(key, 0) + 1
        name = variant("select_reduce", ops)
        want, ms = plain_timed(lambda: plain(select_reduce_plain_sliced, ops, tab, digits))
        _hold(name, f"{what} digits {key}", out, want)
        PLAIN_RUNS.setdefault((name, key), {"ms": ms, "args": (ops, tab, digits)})
        return out

    def msm_finish_checked(ops, S):
        out = msm_finish_cuda(ops, S)
        c = S[0][0] if isinstance(S[0], tuple) else S[0]
        name = variant("msm_finish", ops)
        want, ms = plain_timed(lambda: plain(fin.msm_finish_plain, ops, S))
        _hold(name, f"{what} {tuple(c.shape)}", out, want)
        if c.ndim in (3, 4):  # (W, [rows,] n, NT), as time_k1_finish views K1's output
            rows = c.shape[1] if c.ndim == 4 else 1
            PLAIN_RUNS.setdefault((name, (c.shape[0], rows, c.shape[-1])),
                                  {"ms": ms, "args": (ops, S)})
        return out

    lm_cuda.mont_mul_cuda, k1.select_reduce_cuda = mont_mul_checked, select_reduce_checked
    fin.msm_finish_cuda, field_cuda.mont_mul_bm_cuda = msm_finish_checked, mont_mul_bm_checked
    try:
        t = time.time()
        result = run()  # ends on the host
    finally:
        lm_cuda.mont_mul_cuda, k1.select_reduce_cuda = mont_mul_cuda, select_reduce_cuda
        fin.msm_finish_cuda, field_cuda.mont_mul_bm_cuda = msm_finish_cuda, mont_mul_bm_cuda
    log(f"checked {what} in {time.time() - t:.1f}s: K2 and K3 bit-exact at {len(seen)} "
        f"distinct operand shapes, K1 limb-exact at {sorted(k1_shapes)} and the finish "
        "after each")
    return result, counts, k1_shapes, k3_counts, sorted(k3_copied)


def _plane(np_rng, spec, shape):
    """Random int32 planes of any (..., n, B) shape (values in [0, p))."""
    import math

    lead, B = math.prod(shape[:-2]), shape[-1]
    if B < 4:  # random lanes only (rand_planes puts 0 and p - 1 in lanes 0, 1)
        return rand_planes(np_rng, spec, (lead, shape[-2], 4))[..., 4 - B:].reshape(shape).contiguous()
    return rand_planes(np_rng, spec, (lead, shape[-2], B)).reshape(shape)


def time_k2(np_rng, proof_shapes: dict, lanes: int | None, path: str = "proof"):
    """K2 at each operand shape of one proof (most launches first), then,
    given `lanes`, at one product wave of the per-key G1 table build (6
    stacked products of 4 rows, `lanes` wide): the wrapper (`ms`), the
    kernel alone (`device_ms`), the host's time to queue one wrapper call
    (`host_us`)."""
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import lm_cuda, spec as fs
    from zkmember_tpu_torch.utils import obs

    names = {s.name: s for s in (fs.BLS_FR, fs.BLS_FQ, fs.BW6_FR, fs.BW6_FQ)}
    cases = [(names[f], sa, sb, k) for (f, sa, sb), k in
             sorted(proof_shapes.items(), key=lambda kv: -kv[1])]
    if lanes:
        wide = (6 * 4, fs.BLS_FQ.n, lanes)
        cases.append((fs.BLS_FQ, wide, wide, 0))
    lib = kernels.library()
    out = []
    for spec, sa, sb, launches in cases:
        a, b = _plane(np_rng, spec, sa), _plane(np_rng, spec, sb)
        got = lm_cuda.mont_mul_cuda(spec, a, b)
        err = _hold("mont_mul", f"timed {spec.name} {sa} x {sb}", got,
                    lm_cuda.mont_mul_plain(spec, a, b))
        raw, keep = raw_launch(lib.zk_mont_mul, lm_cuda.prepare, spec, a, b)
        n_elem = got.numel() // spec.n
        r = {
            "field": spec.name, "shape": list(sa), "operand_b": list(sb), "path": path,
            "launches": launches, "per": "proof" if launches else "key", "max_abs_err": err,
            "ms": cuda_ms(lambda: lm_cuda.mont_mul_cuda(spec, a, b)),
            "device_ms": device_ms(raw),
            "host_us": host_us(lambda: lm_cuda.mont_mul_cuda(spec, a, b)),
            "plain_ms": cuda_ms(lambda: lm_cuda.mont_mul_plain(spec, a, b), reps=1),
            "bound": obs.bound((a.numel() + b.numel() + got.numel()) * 4,
                               n_elem * obs.mont_mul_imads(spec.n)),
            "in_l2": (a.numel() + b.numel() + got.numel()) * 4 <= obs.L2_BYTES,
        }
        del keep
        out.append(r)
        log(f"K2 {spec.name} {sa} x {sb} ({launches or 'per key'}): wrapper {r['ms']:.4f} ms, "
            f"kernel {r['device_ms']:.4f} ms, host {r['host_us']:.1f} us a call, plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return out


def raw_launch(fn, prepare, spec, a, b):
    """One raw launch of a field-product kernel (`fn`, the library's entry) on
    a and b, its arguments prepared once by the wrapper's `prepare`: calling
    it queues the kernel alone.  Returns it and the tensors it points into."""
    import torch

    args, out, operands = prepare(spec, a, b)
    stream = torch.cuda.current_stream().cuda_stream
    return (lambda: fn(*args, stream)), (out, operands)


def _shape_row(r: dict) -> dict:
    """A kernel's entry of the kernels line at one more shape of a path."""
    row = {k: r[k] for k in ("path", "group", "shape", "operand_b", "launches", "max_abs_err",
                             "inputs", "ms", "plain_ms", "device_ms", "host_us", "in_l2",
                             "tail_ms", "join_ms", "waves", "wave_us")
           if k in r}
    return {**row, "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": None}


def phase_profile():
    """One more run of each prover path that ran (prove_lm after `prove`, a
    batch of BATCH_TIMED after `prove_batch`, the depth-32 proof after
    `scale`, the v1 prover after `prove_v1`, the 1,024-member pedersen381
    hash and tree after `hash`, a Marlin proof after `marlin`)
    under torch.profiler: the kernels' device time, the device's idle share
    against that path's timed run, and the kernels with the most device
    time.  Not part of the
    default run: reading a trace of ~200k launches takes minutes."""
    from zkmember_tpu_torch.snark import groth16, marlin, prove_lm

    if "keys" in STATE:
        _profile("profile", RESULTS["prove_s"],
                 lambda: prove_lm.prove(STATE["keys"], STATE["cs"], rng=STATE["rng"]))
    if "batch" in STATE:
        keys, batch = STATE["batch"]
        _profile("profile_batch",
                 statistics.median(RESULTS["prove_batch"][f"P{len(batch)}"]["prove_batch_s"]),
                 lambda: prove_lm.prove_batch(keys, batch))
    if "scale" in STATE:
        keys, cs = STATE["scale"]
        prove_s = next(r["seconds"] for r in RESULTS["scale"]["rows"]
                       if r["name"].endswith("depth32_prove"))
        _profile("profile_scale", prove_s, lambda: prove_lm.prove(keys, cs))
    if "bw6" in STATE:
        keys, cs, rng = STATE["bw6"]
        _profile("profile_bw6", RESULTS["bw6"]["prove_s"], lambda: prove_lm.prove(keys, cs, rng=rng))
    if "pk_v1" in STATE:
        cs, _, rng = _membership_circuit(16)
        _profile("profile_v1", RESULTS["prove_v1_s"],
                 lambda: groth16.prove(STATE["pk_v1"], cs, rng=rng, device="cuda"))
    if "hash" in STATE:
        stack, leaf_params, node_params, members = STATE["hash"]
        _profile("profile_hash", RESULTS["hash"][stack]["s"],
                 lambda: _hash_tree_run(stack, leaf_params, node_params, members))
    if "marlin" in STATE:
        ipk, cs, state = STATE["marlin"]
        _profile("profile_marlin", RESULTS["marlin"]["prove_s"],
                 lambda: marlin.prove(ipk, cs, rng=_rng_at(state), device="cuda"))


def _profile(label: str, timed_s: float, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    t = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    out = {
        "wall_s_profiled": wall, "device_kernel_s": busy,
        # against the unprofiled timed proof: the profiler slows the host, not the kernels
        "device_idle_share": 1 - busy / timed_s,
        "device_kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "count": e.count, "device_s": dev_us(e) / 1e6}
                        for e in top],
    }
    print(json.dumps({label: out}))
    log(f"{label}: wall {wall:.2f}s, kernels {busy:.3f}s on the card, "
        f"{out['device_kernel_launches']} kernel launches")


# ---------------------------------------------------------------------------
# the v1 (batch-major) slice: K3, setup, the v1 prover, the CLI
# ---------------------------------------------------------------------------


def rand_rows(np_rng, spec, shape):
    """Random (..., n) int32 rows of values in [0, p); the first three rows
    are 0, 1 and p - 1."""
    import numpy as np
    import torch

    n = spec.n
    limbs = np_rng.integers(0, 1 << 16, size=tuple(shape), dtype=np.int64)
    flat = limbs.reshape(-1, n)
    flat[:, n - 1] %= int(spec.p_limbs[-1])  # top limb below p's: value < p
    flat[0] = 0
    flat[1] = 0
    flat[1, 0] = 1
    flat[2] = spec.p_limbs.astype(np.int64)
    flat[2, 0] -= 1
    return torch.as_tensor(limbs, dtype=torch.int32, device="cuda")


def mont_mul_bm_plain_rows(spec, a, b, chunk: int = 1 << 21):
    """The plain K3 version over row chunks, joined: the int64 temporaries
    of the widest v1 shapes do not fit the card at once."""
    import numpy as np
    import torch

    from zkmember_tpu_torch.fields import field_cuda

    shape = tuple(np.broadcast_shapes(a.shape, b.shape))
    a2 = a.expand(shape).reshape(-1, spec.n)
    b2 = b.expand(shape).reshape(-1, spec.n)
    parts = [field_cuda.mont_mul_bm_plain(spec, a2[i : i + chunk], b2[i : i + chunk])
             for i in range(0, a2.shape[0], chunk)]
    return torch.cat(parts).reshape(shape)


def phase_k3(np_rng):
    from zkmember_tpu_torch.fields import field_cuda, spec as fs

    k3 = field_cuda.mont_mul_bm_cuda
    for spec, rows in ((fs.BLS_FR, 8192), (fs.BLS_FQ, 65536), (fs.BW6_FR, 8192),
                       (fs.BW6_FQ, 4096)):
        a = rand_rows(np_rng, spec, (rows, spec.n))
        b = rand_rows(np_rng, spec, (rows, spec.n))
        _hold("mont_mul_bm", f"{spec.name} ({rows}, {spec.n})", k3(spec, a, b),
              mont_mul_bm_plain_rows(spec, a, b))
        a3 = rand_rows(np_rng, spec, (3, rows // 4, spec.n))
        for c in (b[2], b[1], b[5]):  # (n,) operands: p - 1, 1, a random value
            _hold("mont_mul_bm", f"{spec.name} (3, {rows // 4}, {spec.n}) x ({spec.n},)",
                  k3(spec, a3, c), mont_mul_bm_plain_rows(spec, a3, c))
        tw = rand_rows(np_rng, spec, (rows // 4, spec.n))  # a twiddle table
        _hold("mont_mul_bm", f"{spec.name} (3, {rows // 4}, {spec.n}) x ({rows // 4}, {spec.n})",
              k3(spec, a3, tw), mont_mul_bm_plain_rows(spec, a3, tw))
        log(f"K3 mont_mul_bm {spec.name}: bit-exact against the plain version "
            "(random rows, 0, 1, p - 1, broadcast operands)")

    # times at the v1 path's shapes: an NTT stage of the H pipeline (three
    # stacked transforms and one), the fixed-base step's six stacked products
    # over a 16,384-row tile, and the widest Pippenger wave (six stacked
    # products over the (32 windows, 8192 pairs) grid); then BW6-761's
    # fixed-base step (Fq at n = 48, the same tile)
    timed = [time_k3(np_rng, spec, shape, b_shape)
             for spec, shape, b_shape in ((fs.BLS_FR, (8192, 16), (8192, 16)),
                                          (fs.BLS_FR, (3, 8192, 16), (8192, 16)),
                                          (fs.BLS_FQ, (6, 16384, 24), (6, 16384, 24)),
                                          (fs.BLS_FQ, (6, 32, 8192, 24), (6, 32, 8192, 24)),
                                          (fs.BW6_FQ, (6, 16384, 48), (6, 16384, 48)))]
    RESULTS["mont_mul_bm_shapes"] = timed
    RESULTS["mont_mul_bm"] = timed[2]  # the fixed-base / curve-op wave
    RESULTS["mont_mul_bm_bw6"] = timed[4]  # the same wave over BW6-761 Fq


def time_k3(np_rng, spec, shape, b_shape) -> dict:
    """K3 on random rows of `shape` x `b_shape`, held against its plain
    version, then timed: the wrapper (`ms`), the kernel alone (`device_ms`),
    the host's time a call (`host_us`), the plain version, the bound."""
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import field_cuda
    from zkmember_tpu_torch.utils import obs

    k3 = field_cuda.mont_mul_bm_cuda
    a = rand_rows(np_rng, spec, shape)
    b = rand_rows(np_rng, spec, b_shape)
    err = _hold("mont_mul_bm", f"timed {spec.name} {shape} x {b_shape}", k3(spec, a, b),
                mont_mul_bm_plain_rows(spec, a, b))
    rows = a.numel() // spec.n
    nbytes = (a.numel() + b.numel() + a.numel()) * 4
    raw, keep = raw_launch(kernels.library().zk_mont_mul_bm, field_cuda.prepare, spec, a, b)
    r = {
        "field": spec.name, "shape": list(shape), "operand_b": list(b.shape),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: k3(spec, a, b)),
        "device_ms": device_ms(raw),
        "host_us": host_us(lambda: k3(spec, a, b)),
        "plain_ms": cuda_ms(lambda: mont_mul_bm_plain_rows(spec, a, b), reps=1),
        "bound": obs.bound(nbytes, rows * obs.mont_mul_imads(spec.n)),
        "in_l2": nbytes <= obs.L2_BYTES,
    }
    del keep
    log(f"K3 at {shape} x {tuple(b.shape)}: wrapper {r['ms']:.4f} ms, kernel "
        f"{r['device_ms']:.4f} ms, host {r['host_us']:.1f} us a call, plain "
        f"{r['plain_ms']:.2f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
    return r


def phase_setup():
    import numpy as np
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import groth16
    from zkmember_tpu_torch.utils import checkpoint
    from zkmember_tpu_torch.utils import serialize as ser

    cs, public, rng = _membership_circuit(16)
    kernels.reset_launches()
    torch.cuda.synchronize()
    phases: dict = {}
    t = time.time()
    pk, vk = groth16.setup(cs, "bls12_381", rng, device="cuda", phase_times=phases)
    setup_s = time.time() - t
    RESULTS["launches_setup"] = dict(kernels.LAUNCHES)
    if RESULTS["launches_setup"]["mont_mul_bm"] == 0:
        raise AssertionError("setup launched no mont_mul_bm")
    RESULTS["setup"] = {"setup_s": setup_s, **phases}
    log(f"setup in {setup_s:.2f}s (phases synchronized): " + ", ".join(
        f"{k} {v:.3f}s" for k, v in phases.items())
        + f"; K3 launches {RESULTS['launches_setup']['mont_mul_bm']}")

    ck = os.path.join(REPO, "artifacts", "groth16_bls12_381_16")
    got = checkpoint.query_arrays(pk)
    with np.load(ck + ".npz") as data:
        want = {k: data[k] for k in data.files}
    if sorted(got) != sorted(want) or len(want) != 12:
        raise AssertionError(f"query arrays {sorted(got)} differ from the checkpoint's {sorted(want)}")
    for k in sorted(want):
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"setup's {k} differs from the checkpoint's")
    with open(ck + ".json") as f:
        meta = json.load(f)
    g1 = groth16.pairing_config("bls12_381").mod.G1
    mine = {
        "beta_g1": ser.sw_point_to_bytes(g1, pk.beta_g1).hex(),
        "delta_g1": ser.sw_point_to_bytes(g1, pk.delta_g1).hex(),
        "vk": ser.vk_to_bytes(vk).hex(),
        "a_nonzero": pk.a_nonzero, "b_nonzero": pk.b_nonzero, "l_nonzero": pk.l_nonzero,
        "domain_size": pk.domain_size, "num_instance": pk.num_instance,
    }
    for k, v in mine.items():
        if meta[k] != v:
            raise AssertionError(f"setup's {k} differs from the checkpoint's")
    log("setup reproduces the committed key: all 12 query arrays limb for limb, "
        "beta_g1, delta_g1, vk and the index lists")
    STATE.update(pk_v1=pk)


def checked_v1_proof(pk, cs, rng):
    """One v1 proof under ``checked_run``; no K3 operand may be copied."""
    from zkmember_tpu_torch.snark import groth16

    proof, _, _, _, copied = checked_run(
        lambda: groth16.prove(pk, cs, rng=rng, device="cuda"), "v1 proof")
    if copied:
        raise AssertionError(f"K3 copies an operand in the v1 proof: {copied}")
    return proof


def phase_prove_v1():
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    cs, public, rng = _membership_circuit(16)
    if "pk_v1" not in STATE:
        raise AssertionError("prove_v1 needs the setup phase before it")
    pk = STATE["pk_v1"]
    vk = pk.vk
    t = time.time()
    groth16.prove(pk, cs, rng=rng, device="cuda")
    log(f"warm-up v1 proof in {time.time() - t:.2f}s")

    state = rng.getstate()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    proof = groth16.prove(pk, cs, rng=_rng_at(state), device="cuda")
    prove_s = time.time() - t
    launches = dict(kernels.LAUNCHES)
    log(f"timed v1 proof in {prove_s:.3f}s; launches {launches}")
    if launches["mont_mul_bm"] == 0:
        raise AssertionError("the v1 proof launched no mont_mul_bm")
    if any(launches[k] for k in PROVE_KERNELS + BW6_KERNELS):
        raise AssertionError(f"the v1 proof launched limb-major kernels: {launches}")
    RESULTS["prove_v1_s"] = prove_s
    RESULTS["launches_v1"] = launches
    RESULTS["breakdown_v1"] = traced_proof(
        lambda phases: groth16.prove(pk, cs, rng=_rng_at(state), device="cuda",
                                     phase_times=phases),
        "v1 proof", V1_PHASES, proof, vk, public)
    log("phases of a v1 proof synchronized at each phase: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in RESULTS["breakdown_v1"].items()))

    _holds_and_tamper_fails(groth16.pairing_config("bls12_381"), vk, public, proof, "v1 proof")
    keys = STATE.get("keys") or checkpoint.load_groth16_keys(
        os.path.join(REPO, "artifacts", "groth16_bls12_381_16"), device="cuda")
    lm_proof = prove_lm.prove(keys, cs, rng=_rng_at(state))
    if (lm_proof.a, lm_proof.b, lm_proof.c) != (proof.a, proof.b, proof.c):
        raise AssertionError("the v1 proof differs from the limb-major prover's with the "
                             "same keys and rng state")
    if not groth16.verify(keys.pk.vk, public, lm_proof):
        raise AssertionError("the limb-major proof does not verify")
    log("the v1 proof equals prove_lm's proof from the committed key with the same rng state")
    checked = checked_v1_proof(pk, cs, _rng_at(state))
    if (checked.a, checked.b, checked.c) != (proof.a, proof.b, proof.c):
        raise AssertionError("the checked v1 proof differs from the timed one")


def traced_proof(prove, what: str, names, want, vk, public) -> dict:
    """prove(phase_times) with ZKMEMBER_TRACE=1 and stderr captured.  Raise
    unless every line the prover prints is '# ' + JSON or a row of its
    phase table; the phase lines carry `names` in order, as the phase
    times do; their seconds add up to at most the proof's wall time and
    at least 90 % of it; a prove_lm proof prints one msm_all line over its
    g1_*/g2_* phases with 0 < mfu_vs_imad_peak <= 1.05 (the v1 prover
    prints none, as the reference's); and the proof equals `want` (the
    untraced proof from the same rng state) and verifies.  Records the
    msm_all line in TRACES; returns the phase times with total_s, the
    proof's wall time."""
    import contextlib
    import io
    import re

    import torch

    from zkmember_tpu_torch.snark import groth16

    phases: dict = {}
    buf = io.StringIO()
    old = os.environ.get("ZKMEMBER_TRACE")
    os.environ["ZKMEMBER_TRACE"] = "1"
    torch.cuda.synchronize()
    try:
        with contextlib.redirect_stderr(buf):
            t = time.perf_counter()
            proof = prove(phases)
            wall = time.perf_counter() - t
    finally:
        if old is None:
            del os.environ["ZKMEMBER_TRACE"]
        else:
            os.environ["ZKMEMBER_TRACE"] = old
    recs, table = [], {}
    for line in buf.getvalue().splitlines():
        m = re.fullmatch(r"  (\S+)\s+(\d+\.\d{3})s", line)
        if m:
            table[m.group(1)] = float(m.group(2))
        elif line.startswith("# "):
            recs.append(json.loads(line[2:]))
        else:
            raise AssertionError(f"the traced {what} printed {line!r}")
    lines = [r for r in recs if "phase" in r]
    metrics = [r for r in recs if "phase" not in r]
    got = tuple(r["phase"] for r in lines)
    if got != tuple(names) or tuple(phases) != tuple(names) or set(table) != set(names):
        raise AssertionError(f"the traced {what}'s phases {got} (table {sorted(table)}) are "
                             f"not {names}")
    total = sum(phases.values())
    if abs(sum(r["s"] for r in lines) - total) > 5e-5 * len(lines) + 1e-9:
        raise AssertionError(f"the traced {what}'s lines do not carry its phase times")
    if not 0.9 * wall <= total <= wall:
        raise AssertionError(f"the traced {what}'s phases add up to {total:.4f} s of its "
                             f"{wall:.4f} s")
    msm = None
    if names == V1_PHASES:
        if metrics:
            raise AssertionError(f"the traced {what} printed {metrics}")
    else:
        if [r.get("metric") for r in metrics] != ["msm_all"]:
            raise AssertionError(f"the traced {what} printed {metrics}, not one msm_all line")
        msm = metrics[0]
        msm_s = sum(v for k, v in phases.items() if k.startswith(("g1_", "g2_")))
        if abs(msm["seconds"] - msm_s) > 1e-4 or not 0 < msm["mfu_vs_imad_peak"] <= 1.05:
            raise AssertionError(f"the traced {what}'s msm_all line {msm} (MSM phases "
                                 f"{msm_s:.4f} s)")
    if not _same_proof(proof, want):
        raise AssertionError(f"the traced {what} differs from the untraced one")
    if not groth16.verify(vk, public, proof):
        raise AssertionError(f"the traced {what} does not verify")
    TRACES.append({"path": what, "wall_s": wall, "phases_s": total, "msm_all": msm})
    log(f"traced {what}: {len(lines)} phase lines, {total:.4f} s of {wall:.4f} s; "
        + (f"msm_all {json.dumps(msm)}" if msm else "no msm_all line (v1)"))
    return {"total_s": wall, **phases}


def _rng_at(state):
    import random

    rng = random.Random()
    rng.setstate(state)
    return rng


def _holds_and_tamper_fails(cfg, vk, public, proof, what: str) -> None:
    """Raise unless `proof` verifies for `public`, and neither it with C
    negated nor it for a wrong last public input (the leaf plus one) does."""
    from zkmember_tpu_torch.snark import groth16

    if not groth16.verify(vk, public, proof):
        raise AssertionError(f"the {what} does not verify")
    bad_c = groth16.Proof(curve=proof.curve, a=proof.a, b=proof.b, c=cfg.mod.G1.neg(proof.c))
    if groth16.verify(vk, public, bad_c):
        raise AssertionError(f"a {what} with C negated verifies")
    if groth16.verify(vk, [*public[:-1], (public[-1] + 1) % cfg.r], proof):
        raise AssertionError(f"the {what} verifies for a wrong public input")
    log(f"{what} verifies; negated C and a wrong public input are rejected")


def _release_card() -> None:
    """Hand the memory this process's allocator caches back to the card, so
    that a subprocess can take it (the plain versions' temporaries leave
    tens of GB cached)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _cli(args, env, cwd, stdin=None, want_rc=0):
    _release_card()
    t = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "zkmember_tpu_torch.app.cli", *args], input=stdin,
        capture_output=True, text=True, env=env, cwd=cwd, timeout=900,
    )
    cmd = next(a for a in args if a in ("register", "root", "prove", "verify", "interactive"))
    log(f"cli {' '.join(args[:args.index(cmd) + 1])}: exit {res.returncode} in "
        f"{time.time() - t:.1f}s")
    if res.returncode != want_rc:
        raise AssertionError(f"cli {args} exited {res.returncode}, expected {want_rc}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def _cli_value(out: str, label: str) -> str:
    import re

    plain = re.sub(r"\x1b\[[0-9;]*m", "", out)
    for line in plain.splitlines():
        if line.startswith(label):
            return line[len(label):].strip()
    raise AssertionError(f"cli output has no {label!r} line:\n{plain[-2000:]}")


def phase_cli():
    RESULTS["cli_s"] = _cli_members("pedersen381", 16, 5, 5)


def _cli_members(stack: str, members: int, prove_id: int, other_idx: int) -> float:
    """The CLI with --stack in subprocesses: `interactive` registers members
    1 .. members - 1 and `register` the last, `root`, `prove --id prove_id`
    (inline verification true), `verify` (exit 0) and `verify` against the
    leaf of the member at other_idx in the state file (exit 1).  `root`
    runs beside `prove`, and the two `verify`s beside each other: none
    writes the state file, and no time of theirs is reported but the
    whole.  Returns the seconds."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from zkmember_tpu_torch.app.member import Member

    t0 = time.time()
    st = ["--stack", stack]
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".cli_") as tmp:
        env = dict(os.environ, PYTHONPATH=REPO, ZKMEMBER_STATE=os.path.join(tmp, "state.json"))
        stdin = "".join(f"1\n{i}\n{i}@usc.edu\n" for i in range(1, members)) + "q\n"
        _cli(st + ["interactive"], env, tmp, stdin=stdin)
        out = _cli(st + ["register", "--id", str(members), "--email", f"{members}@usc.edu"],
                   env, tmp)
        if _cli_value(out, "Number of Members:") != str(members):
            raise AssertionError(f"the {stack} registrar does not hold {members} members:\n{out}")
        root = int(_cli_value(out, "Merkle Root:"), 16)
        with ThreadPoolExecutor(1) as pool:
            root_out = pool.submit(_cli, st + ["root"], env, tmp)
            out = _cli(st + ["prove", "--id", str(prove_id)], env, tmp)
            if int(root_out.result().strip(), 16) != root:
                raise AssertionError(f"{stack} `root` differs from the root `register` printed")
        if _cli_value(out, "Inline verification:") != "True":
            raise AssertionError(f"{stack} prove's inline verification failed:\n{out}")
        leaf, proof, vk = (_cli_value(out, k) for k in ("Leaf:", "Proof:", "VK:"))
        if int(_cli_value(out, "Root:"), 16) != root:
            raise AssertionError(f"{stack} prove used another root")
        with open(env["ZKMEMBER_STATE"]) as f:
            other = Member.from_json(json.dumps(json.load(f)[other_idx]))
        # the leaf CRH parameters, the same at every registrar size
        other_leaf = hex(other.hash(_registrar(16, stack)[1]))
        if int(other_leaf, 16) == int(leaf, 16):
            raise AssertionError("two members share a leaf")
        with ThreadPoolExecutor(1) as pool:
            rejected = pool.submit(_cli, st + ["verify", "--root", hex(root), "--leaf", other_leaf,
                                               "--proof", proof, "--vk", vk], env, tmp, None, 1)
            _cli(st + ["verify", "--root", hex(root), "--leaf", leaf, "--proof", proof, "--vk",
                       vk], env, tmp)
            rejected.result()
    seconds = time.time() - t0
    log(f"cli {stack}: {members} members registered, prove verified inline, verify accepts "
        f"the proof and rejects another member's leaf ({seconds:.1f}s)")
    return seconds


# ---------------------------------------------------------------------------
# batched proving and the app harnesses
# ---------------------------------------------------------------------------

BATCH_CHECKED, BATCH_TIMED = 4, 8  # proofs in the checked and the timed batch


def _same_proof(a, b) -> bool:
    return (a.a, a.b, a.c) == (b.a, b.b, b.c)


def _batch_equals_sequential(keys, circuits, state, what: str):
    """prove_batch over circuits [(cs, public), ...] from rng `state`,
    launches counted: raise unless each proof equals the sequential prove
    call's with the same rng state, verifies, and is rejected for the next
    member's leaf.  Returns the proofs, the batch's seconds, its launches
    and K1's and the finish's launches by K1 digit shape
    (``_k1_finish_launches``)."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import groth16, prove_lm

    P = len(circuits)
    torch.cuda.synchronize()
    t = time.time()
    proofs, k1_shapes, fin_shapes, _, _ = _launches_by_shape(
        lambda: prove_lm.prove_batch(keys, [c for c, _ in circuits], rng=_rng_at(state)))
    seconds = time.time() - t
    launches = dict(kernels.LAUNCHES)
    seq_rng = _rng_at(state)
    for i, (proof, (cs, public)) in enumerate(zip(proofs, circuits)):
        if not _same_proof(proof, prove_lm.prove(keys, cs, rng=seq_rng)):
            raise AssertionError(f"{what} proof {i} differs from the sequential proof")
        if not groth16.verify(keys.pk.vk, public, proof):
            raise AssertionError(f"{what} proof {i} does not verify")
        other = circuits[(i + 1) % P][1]
        if groth16.verify(keys.pk.vk, [public[0], other[1]], proof):
            raise AssertionError(f"{what} proof {i} verifies for another member's leaf")
    log(f"{what} of {P} (first) in {seconds:.2f}s: every proof verifies, equals {P} sequential "
        "prove calls with the same rng state, and is rejected for another member's leaf")
    return proofs, seconds, launches, _k1_finish_launches(k1_shapes, fin_shapes)


def phase_prove_batch(np_rng):
    """prove_lm.prove_batch over the committed 16-member key: distinct
    members of one registrar; a batch of BATCH_CHECKED is checked (every
    proof verifies, equals the proof of sequential prove calls with the same
    rng state, fails for another member's leaf; every kernel call of one
    more batch held against its plain version), a batch of BATCH_TIMED is
    timed beside a single proof of this process; then K1 and the finish
    are timed at both batches' shapes."""
    import random

    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    keys = STATE.get("keys") or checkpoint.load_groth16_keys(
        os.path.join(REPO, "artifacts", "groth16_bls12_381_16"), device="cuda")
    prove_lm.warm(keys)
    idxs = random.Random(1).sample(range(16), BATCH_TIMED)
    t = time.time()
    circuits = [_member_circuit(16, i) for i in idxs]
    log(f"{len(idxs)} member circuits (members {idxs}) in {time.time() - t:.1f}s")
    cs_all = [cs for cs, _ in circuits]
    vk = keys.pk.vk
    state = _registrar(16)[-1]

    # checked batch: equal to sequential proofs, each verifies, bound to its leaf
    P = BATCH_CHECKED
    proofs, *_ = _batch_equals_sequential(keys, circuits[:P], state, "batch")
    checked, k2_shapes, *_ = checked_run(
        lambda: prove_lm.prove_batch(keys, cs_all[:P], rng=_rng_at(state)), f"batch of {P}")
    if not all(_same_proof(a, b) for a, b in zip(checked, proofs)):
        raise AssertionError("the checked batch differs from the first one")
    if k2_shapes != k2_proof_shapes(keys.M, P):
        raise AssertionError(f"the batch's K2 shapes {k2_shapes} differ from "
                             f"{k2_proof_shapes(keys.M, P)}")

    # timed: one proof, then batches of BATCH_CHECKED and BATCH_TIMED
    rng = _rng_at(state)
    t = time.time()
    prove_lm.prove(keys, cs_all[0], rng=rng)
    single_s = time.time() - t
    out = {"prove_s": single_s, "members": idxs}
    for P in (BATCH_CHECKED, BATCH_TIMED):
        batch = cs_all[:P]
        prove_lm.prove_batch(keys, batch, rng=rng)  # warm-up at this shape
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.time()
        proofs = prove_lm.prove_batch(keys, batch, rng=rng)
        batch_s = time.time() - t
        launches = dict(kernels.LAUNCHES)
        expect = {"mont_mul": 3 * (keys.M.bit_length() - 1) + 6, "select_reduce_fp": 1,
                  "select_reduce_fp2": 1, "msm_finish_fp": 2, "msm_finish_fp2": 2,
                  "mont_mul_bm": 0, "select_reduce_fp48": 0, "msm_finish_fp48": 0}
        if launches != expect:
            raise AssertionError(f"the batch of {P} launched {launches}, not {expect}")
        if not all(groth16.verify(vk, circuits[i][1], p) for i, p in enumerate(proofs)):
            raise AssertionError(f"a proof of the timed batch of {P} does not verify")
        reps = [batch_s]
        for _ in range(2):
            t = time.time()
            prove_lm.prove_batch(keys, batch, rng=rng)
            reps.append(time.time() - t)
        phases: dict = {}
        t = time.time()
        prove_lm.prove_batch(keys, batch, rng=rng, phase_times=phases)
        out[f"P{P}"] = {
            "prove_batch_s": reps, "proofs_per_s": P / statistics.median(reps),
            "launches": launches, "phases_s": {"total_s": time.time() - t, **phases},
        }
        log(f"batch of {P}: {', '.join(f'{x:.3f}' for x in reps)} s "
            f"({P / statistics.median(reps):.2f} proofs/s; one proof {single_s:.3f} s, "
            f"{1 / single_s:.2f} proofs/s); launches {launches}; phases " + ", ".join(
                f"{k} {v:.3f}s" for k, v in out[f'P{P}']['phases_s'].items()))
    out["launches"] = out[f"P{BATCH_TIMED}"]["launches"]
    RESULTS["prove_batch"] = out
    STATE["batch"] = (keys, cs_all[:BATCH_TIMED])
    for P in (BATCH_CHECKED, BATCH_TIMED):
        time_msm_kernels(np_rng, keys, P, f"batch of {P}", out[f"P{P}"]["launches"])


def _run_module(module: str, args, want_rc: int = 0):
    """python -m <module> <args> from the root of the checkout; its stdout."""
    _release_card()
    t = time.time()
    res = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=900)
    log(f"{module} {' '.join(args)}: exit {res.returncode} in {time.time() - t:.1f}s")
    if res.returncode != want_rc:
        raise AssertionError(f"{module} {args} exited {res.returncode}, expected {want_rc}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def _listing(d: str) -> list:
    """A directory's files and their modification times."""
    return sorted((f, os.stat(os.path.join(d, f)).st_mtime_ns) for f in os.listdir(d))


def phase_harness():
    """The bench harness in subprocesses: the Groth16 grid at 16 members with
    the committed key (loaded, not written), then --batch 4."""
    art = os.path.join(REPO, "artifacts")
    before = _listing(art)
    base = ["--sizes", "16", "--checkpoint-dir", "artifacts", "--reps", "3"]
    out = {}
    for label, args in (("grid", base), ("batch", base + ["--batch", "4"])):
        t = time.time()
        rows = [json.loads(line) for line in
                _run_module("zkmember_tpu_torch.app.bench_harness", args).splitlines()
                if line.startswith("{")]
        out[label] = {"rows": rows, "wall_s": time.time() - t}
    names = [r["name"] for r in out["grid"]["rows"]]
    want = (["bls12_381_groth16_setup_load_16"] + ["bls12_381_groth16_prove_16"] * 4
            + ["bls12_381_groth16_verify_16"])
    if names != want:
        raise AssertionError(f"the grid's rows {names} are not {want}")
    if out["grid"]["rows"][-1].get("verified") is not True:
        raise AssertionError("the grid's proof does not verify")
    batch = out["batch"]["rows"]
    if ([r["name"] for r in batch] != ["bls12_381_groth16_batch_prove_16"]
            or batch[0].get("verified") is not True or batch[0].get("batch") != 4
            or not batch[0].get("proofs_per_sec", 0) > 0):
        raise AssertionError(f"the --batch 4 row is not a verified batch of 4: {batch}")
    if _listing(art) != before:
        raise AssertionError("the harness wrote into artifacts/ although the key exists")
    RESULTS["harness"] = out
    log(f"harness: grid rows {names} verified; --batch 4 at {batch[0]['proofs_per_sec']} "
        "proofs/s, verified; artifacts/ unchanged")


# the bench phase: bench_cuda.py as users run it (the committed 16-member key)
# and its setup branch at a size whose key the card's copy lacks
BENCH_SETUP_MEMBERS = 64
BENCH_SWEEP = (16, 50, 64, 100, 128, 512, 1000, 1024)  # bench.py's sizes (benches/groth16.rs)
# artifacts/groth16_bls12_381_64.*, which .chiprunignore keeps off the card: each query
# array's SHA-256 (its uint32 bytes, as checkpoint.query_arrays gives them) and the json's
# vk, beta_g1 and delta_g1.  That key came from the JAX bench harness's sweep (one fresh
# test rng over the sizes), not from bench.py's draws: its setup found a fresh test rng
# after KEY64_DRAWS field-element draws (tests/test_torch_bench.py holds its host half)
KEY64_DRAWS = 29
KEY64_SHA256 = {
    "a_query_x": "3e240f38c9e9591105715df27766fdf31074c984496d354c0f025e4faaa9f5a6",
    "a_query_y": "4f7b23f5759e6acfbd068408785d22dccf2ffe5614e747d1444209d91ae0be4b",
    "b_g1_query_x": "9985f8cf116fa1dc109beaab28130a188e3d8e4b3e63559a10470c74d14b344f",
    "b_g1_query_y": "572453fbf64860c146be26cf1352723c414c39f3e7429fbf71b17fa4a49d84e5",
    "b_g2_query_x_c0": "58ae2c1bd11365441589ee1a06b0c6cc91591e35a6c0f283ad914fdc991875d5",
    "b_g2_query_x_c1": "202c3cb0ace2f565a7069bbcc78401a02cbf11c210efdb1b851828e7b3f48e5e",
    "b_g2_query_y_c0": "f8afb6ad88bc5fee62be05de1eda099b24d75437433ab7e7b7955071117284ad",
    "b_g2_query_y_c1": "e7d02013a6802d2502cba60c0728523ca49dfc6c6544fee0544e239d36d5778f",
    "h_query_x": "366120bdf8ff318f77463627f696518e60e43691a4f35eacde88ec15d007964b",
    "h_query_y": "235e3578ba7349b59158877d3cf05d69696d582a6dd1b6688cbbbd9373ff6c9e",
    "l_query_x": "d3b023a4b7c0a6d46e34db32de5e440b777ed4cd6b27f90dd50987ec227dd402",
    "l_query_y": "9baeb0c4f1c5248674b4d5dfa1a32ca13c4d8e1aeb6a4a902c29ab1667588147",
}
KEY64_VK = (
    "af731432e3dd1d75e617cd674d730f3594c52a06d69ebcf746ef667908539dde7258f58cb103914a01f94094"
    "ceb0c20be59f6b33d7ec612854e857bd7ee35503b56877fc51a9de15c585089b437cfa6bed54fa8aa4952b75"
    "e7052f274629680439631df443e78184c7f816e2673e08295e56972aaa3333688fba32428ba5a674f69e5815"
    "b1de3e187a7ab997cf0d220eef59ca1a4eee27a713df3a9c0b114d1fc973d2cbf92d7121369d8d42e35e2699"
    "e6073d29ff3af78de9de0135e44cd505f62964beeae0614d7a7dd42b6936f533274ccc5cd4738eba84486bfe"
    "9a4b17e8a5c6ad79a28819d17d10555a8745340394ec618c64b13a95e7eedd92bf34b8c12d7d496273452aa5"
    "215b72d408e5c1957d4b19e716c8e67edd724d9a188640024d7d2593a89e824ea4e4db0318a55fdb1e26fc68"
    "e645cea22bdced02e2478d55a0a5fc4fd25a2764e806f59d18f0429403000000000000005a0ff627fc39763d"
    "4b626f453430b8c2da63c9930febc18aa26146f3e47155a74d4593ce6a021321fd3105a76cb43a117e4da4f7"
    "3839ab7abeba5faba95fa8ec80ff350e4155821a9a99246264cb44d93e988f6c6c254bb17af27fe4288ef503"
    "08df9bbd26f747038d1d2936d7dfe2f37ace856533b30b6c84c8fdf17e9a9f9d4e1d84a415b75b2cdfc5b703"
    "ec42b38b"
)
KEY64_BETA_G1 = ("ca311325ffa4ed99605dfe61020c5428002829b4da1b4f2921f1bf60667524f3"
                 "b1c1f00cdcbcacaa069895c92111d698")
KEY64_DELTA_G1 = ("89020f1486e7c8ad1a80d2331aa421b2d64e6e69279a8fc53a10da3f6603fc00"
                  "9ece19657d2811005d91ea42f6acf202")


def _bench_cli() -> dict:
    """python3 bench_cuda.py as users run it (16 members, the committed key):
    its last stdout line, checked; artifacts/ must be unchanged."""
    import re

    art = os.path.join(REPO, "artifacts")
    before = _listing(art)
    _release_card()
    env = {k: v for k, v in os.environ.items() if k != "BENCH_MEMBERS"}
    t = time.time()
    res = subprocess.run([sys.executable, os.path.join(REPO, "bench_cuda.py")],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    wall_s = time.time() - t
    log(f"python3 bench_cuda.py: exit {res.returncode} in {wall_s:.1f}s")
    if res.returncode != 0:
        raise AssertionError(f"bench_cuda.py exited {res.returncode}:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-4000:]}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    if list(line) != ["metric", "value", "unit", "vs_baseline", "device"]:
        raise AssertionError(f"bench_cuda.py's line has the keys {list(line)}")
    if (line["metric"] != "groth16_bls12_381_prove_16members" or not line["value"] > 0
            or line["unit"] != "s" or line["vs_baseline"] != round(0.300 / line["value"], 3)
            or line["device"] != RESULTS.get("smi", line["device"])):
        raise AssertionError(f"bench_cuda.py's line is wrong: {line}")
    warm = re.findall(r"^# \[warm\] (\w+) ready in \d+\.\ds$", res.stderr, re.M)
    if warm != ["kernels", "tables"] or "proving key loaded from checkpoint" not in res.stderr:
        raise AssertionError(f"bench_cuda.py's stderr lacks the key load or the warm lines:\n"
                             f"{res.stderr[-4000:]}")
    if _listing(art) != before:
        raise AssertionError("bench_cuda.py wrote into artifacts/ although the key exists")
    log(f"bench_cuda.py: {line}; warm lines {warm}; artifacts/ unchanged")
    return dict(line, wall_s=wall_s)


def _bench_setup_branch() -> dict:
    """bench_cuda.main at BENCH_SETUP_MEMBERS with setup on the card into a
    temporary directory (K3, K2, K1 and the finish must launch; main raises
    unless the proof verifies), then again over that directory (the key
    loads, nothing is written, no K3).  Then setup from the committed key's
    rng state must give its query arrays and vk."""
    import hashlib
    import tempfile

    import numpy as np

    import bench_cuda
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.snark import groth16
    from zkmember_tpu_torch.utils import checkpoint
    from zkmember_tpu_torch.utils import rng as frng
    from zkmember_tpu_torch.utils import serialize as ser

    n = BENCH_SETUP_MEMBERS
    need = ("mont_mul_bm", "mont_mul", "select_reduce_fp", "select_reduce_fp2", "msm_finish_fp",
            "msm_finish_fp2")
    out = {}
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".bench_") as tmp:
        for run in ("setup", "load"):
            kernels.reset_launches()
            t = time.time()
            res = bench_cuda.main(members=n, device="cuda", checkpoint_dir=tmp)
            res.update(wall_s=time.time() - t, launches=dict(kernels.LAUNCHES))
            out[run] = res
            if run == "setup":
                saved = _listing(tmp)
        if [f for f, _ in saved] != [f"groth16_bls12_381_{n}.json", f"groth16_bls12_381_{n}.npz"]:
            raise AssertionError(f"the setup branch saved {saved}")
        if _listing(tmp) != saved or out["load"]["setup_s"] is not None:
            raise AssertionError("the second bench run did not load the saved key, or wrote")
    missing = [k for k in need if out["setup"]["launches"][k] == 0]
    if missing or out["setup"]["setup_s"] is None:
        raise AssertionError(f"the setup branch launched no {missing}: {out['setup']}")
    if out["load"]["launches"]["mont_mul_bm"] or any(
            out["load"]["launches"][k] == 0 for k in need[1:]):
        raise AssertionError(f"the loading run's launches are wrong: {out['load']['launches']}")
    log(f"bench_cuda.main({n} members): setup {out['setup']['setup_s']:.2f}s, proof "
        f"{out['setup']['value']}s, verified; again over the saved key: loaded, proof "
        f"{out['load']['value']}s, nothing written")

    # the committed key: setup from the rng state that made it
    cs, _, _ = _membership_circuit(n)
    rng = frng.test_rng()
    for _ in range(KEY64_DRAWS):
        frng.nonzero_field_element(rng, groth16.pairing_config("bls12_381").r)
    t = time.time()
    pk, vk = groth16.setup(cs, "bls12_381", rng, device="cuda")
    got = {k: hashlib.sha256(np.ascontiguousarray(a, dtype=np.uint32).tobytes()).hexdigest()
           for k, a in checkpoint.query_arrays(pk).items()}
    if got != KEY64_SHA256:
        raise AssertionError(f"setup's query arrays differ from the committed {n}-member key's: "
                             f"{sorted(k for k in KEY64_SHA256 if got.get(k) != KEY64_SHA256[k])}")
    g1 = groth16.pairing_config("bls12_381").mod.G1
    if (ser.vk_to_bytes(vk).hex() != KEY64_VK
            or ser.sw_point_to_bytes(g1, pk.beta_g1).hex() != KEY64_BETA_G1
            or ser.sw_point_to_bytes(g1, pk.delta_g1).hex() != KEY64_DELTA_G1):
        raise AssertionError(f"setup's vk, beta or delta differs from the committed {n}-member key's")
    out["committed_key_setup_s"] = time.time() - t
    log(f"setup from the committed {n}-member key's rng state reproduces its 12 query arrays, "
        f"vk, beta_g1 and delta_g1 ({out['committed_key_setup_s']:.2f}s)")
    return out


def phase_bench():
    RESULTS["bench"] = {"cli": _bench_cli(), f"main_{BENCH_SETUP_MEMBERS}": _bench_setup_branch()}


def phase_bench_sweep():
    """bench_cuda.main at each of bench.py's sizes: the committed key where the
    card's copy has it, else setup into a temporary directory."""
    import tempfile

    import bench_cuda
    from zkmember_tpu_torch import kernels

    art = os.path.join(REPO, "artifacts")
    rows = []
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".bench_") as tmp:
        for n in BENCH_SWEEP:
            _release_card()
            have = os.path.exists(os.path.join(art, f"groth16_bls12_381_{n}.json"))
            kernels.reset_launches()
            t = time.time()
            res = bench_cuda.main(members=n, device="cuda", checkpoint_dir=art if have else tmp)
            row = {"members": n, "value": res["value"], "vs_baseline": res["vs_baseline"],
                   "setup_s": res["setup_s"], "M": res["M"], "wall_s": time.time() - t,
                   "launches": dict(kernels.LAUNCHES), "device": res["device"]}
            print(json.dumps({"bench_sweep": row}), flush=True)
            rows.append(row)
    RESULTS["bench_sweep"] = rows


HASH_MEMBERS = 1024  # the reference harness's largest registrar (DEFAULT_SIZES)
HASH_SAMPLE = 64  # leaves of the checked tree; pedersen761's host sample


def _hash_tree_run(stack: str, leaf_params, node_params, members):
    """The slice's path as a user runs it: the members hashed in one batch on
    the card, then the membership tree (the device backend above 64 leaves)."""
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.app.member import Member

    digests = Member.hash_batch(leaf_params, members, "cuda")
    return digests, app.new_membership_tree(leaf_params, node_params, digests, "cuda")


def _leaf_bytes(node_params, digests):
    nbytes = node_params.spec.n * 2
    return [int(d).to_bytes(nbytes, "little") for d in digests]


def _levels_equal(a, b, what: str) -> None:
    import numpy as np

    if len(a.levels) != len(b.levels) or not all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a.levels, b.levels)):
        raise AssertionError(f"{what}: the device tree's levels differ from the host tree's")


def _hash_proof_run() -> dict:
    """The 1,024-member Groth16 proof in this process, as the harness builds
    it (``bench_harness._build`` on the card): setup at M = 2^15, the table
    build and one proof, each under ``checked_run`` (K3 in setup, K2 in the
    tables and the H pipeline, K1 at its digit grids and the finish held
    against their plain versions); then a proof with the launch counts reset
    just before it and read just after, equal in its launches to the shape
    table of the H pipeline; both proofs verify, a tampered one does not."""
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.app import bench_harness as bh
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import rng as frng

    what = f"{HASH_MEMBERS}-member"
    t = time.time()
    cs, root, leaf = bh._build("pedersen381", HASH_MEMBERS, device="cuda")
    build_s = time.time() - t
    t = time.time()
    (pk, _), _, _, k3_setup, copied = checked_run(
        lambda: groth16.setup(cs, curve="bls12_381", rng=frng.test_rng(), device="cuda"),
        f"{what} setup")
    setup_s = time.time() - t
    if copied:
        raise AssertionError(f"K3 copies an operand in the {what} setup: {copied}")
    keys = prove_lm.Groth16KeysLM(pk, "cuda")
    _, k2_tables, *_ = checked_run(lambda: prove_lm.warm(keys), f"{what} table build")
    rng = frng.test_rng(HASH_MEMBERS)
    checked, k2_shapes, k1_shapes, *_ = checked_run(
        lambda: prove_lm.prove(keys, cs, rng=rng), f"{what} proof")
    if keys.M != 1 << 15 or k2_shapes != k2_proof_shapes(keys.M):
        raise AssertionError(f"the {what} proof at M = {keys.M} ran K2 at {k2_shapes}, "
                             f"not {k2_proof_shapes(keys.M)}")
    kernels.reset_launches()
    t = time.time()
    proof = prove_lm.prove(keys, cs, rng=rng)
    prove_s = time.time() - t
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    expect = {"mont_mul": sum(k2_proof_shapes(keys.M).values()), "select_reduce_fp": 1,
              "select_reduce_fp2": 1, "msm_finish_fp": 2, "msm_finish_fp2": 2}
    if launches != expect:
        raise AssertionError(f"the {what} proof launched {launches}, not {expect}")
    _holds_and_tamper_fails(keys.cfg, pk.vk, [root, leaf], checked, f"checked {what} proof")
    _holds_and_tamper_fails(keys.cfg, pk.vk, [root, leaf], proof, f"{what} proof")
    r = {"M": keys.M, "constraints": cs.num_constraints, "build_s": build_s,
         "checked_setup_s": setup_s, "prove_s": prove_s, "launches": launches,
         "setup_launches": {"mont_mul_bm": sum(k3_setup.values())},
         "table_launches": {"mont_mul": sum(k2_tables.values())},
         "k1_shapes": [list(k) for k in k1_shapes]}
    log(f"{what} proof in this process: build {build_s:.1f}s, checked setup {setup_s:.1f}s "
        f"(K3 {r['setup_launches']['mont_mul_bm']} launches), proof {prove_s:.3f}s with "
        f"launches {launches}, M = {keys.M}, {cs.num_constraints} constraints")
    return r


def phase_hash(np_rng):
    """Pedersen hashing and Merkle levels on the card, both stacks: a checked
    run of the 1,024-member path and of a 64-leaf tree (K3 held against its
    plain version at every distinct operand shape: every te_add wave of every
    round, the inverse's rows, from_mont); the 1,024-member path timed twice
    with the launch counts reset just before it and read just after (K3
    only); at pedersen381 the same tree on the host, timed, equal level for
    level, and hash_batch equal to host Member.hash for every member; at
    pedersen761 both held against the host on 64 members and 64 leaves;
    entry() on the card equal to two_to_one_host; the 1,024-member proof
    in this process, checked (``_hash_proof_run``); the bench harness's
    Groth16 grid at 1,024 members with setup on the card (M = 2^15); K3
    timed at the widest te_add wave and at the inverse's rows."""
    import numpy as np
    import torch

    from zkmember_tpu_torch import entry, kernels
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.app.member import generate_members
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.hash import pedersen as ph
    from zkmember_tpu_torch.merkle import tree as mt
    from zkmember_tpu_torch.utils import rng as frng

    out = {}
    for stack in ("pedersen381", "pedersen761"):
        r = out[stack] = {}
        t = time.time()
        leaf_params, node_params = app.get_config(stack).setup_params(frng.test_rng())
        r["params_s"] = time.time() - t
        members = generate_members(HASH_MEMBERS)
        # the whole path under checked_run: K3 at its shapes and launches per
        # shape, and where the wrapper copies an operand (the te_add waves'
        # stacks are copies made by torch.stack, before the wrapper)
        (digests, tree), _, _, k3_shapes, copied = checked_run(
            lambda: _hash_tree_run(stack, leaf_params, node_params, members),
            f"{stack} {HASH_MEMBERS}-member hash")
        r["k3_copied_at"] = [list(map(list, c[1:])) for c in copied]
        leaves = _leaf_bytes(node_params, digests[:HASH_SAMPLE])
        checked_tree, *_ = checked_run(lambda: mt.MerkleTree(
            leaf_params, node_params, leaves, backend="device", device="cuda"),
            f"{stack} {HASH_SAMPLE}-leaf tree")
        t = time.time()
        host_tree = mt.MerkleTree(leaf_params, node_params, leaves, backend="host")
        r["host_tree_64_s"] = time.time() - t
        _levels_equal(checked_tree, host_tree, f"{stack} at {HASH_SAMPLE} leaves")
        runs = []
        for _ in range(2):  # a first and a second run of the path in this process
            kernels.reset_launches()
            t = time.time()
            digests2, tree2 = _hash_tree_run(stack, leaf_params, node_params, members)
            runs.append({"s": time.time() - t,
                         "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}})
        for run in runs:
            if set(run["launches"]) != {"mont_mul_bm"}:
                raise AssertionError(f"{stack}: the hash path launched {run['launches']}")
        if digests2 != digests:
            raise AssertionError(f"{stack}: a second hash_batch gave other digests")
        _levels_equal(tree2, tree, f"{stack}: a second device tree")
        if stack == "pedersen381":  # the whole tree and every member on the host
            t = time.time()
            host_digests = [m.hash(leaf_params) for m in members]
            r["host_hash_s"] = time.time() - t
            t = time.time()
            host_full = mt.MerkleTree(leaf_params, node_params, _leaf_bytes(node_params, digests),
                                      backend="host")
            r["host_tree_s"] = time.time() - t
            _levels_equal(tree, host_full, f"{stack} at {HASH_MEMBERS} leaves")
            if host_full.root() != tree.root():
                raise AssertionError("the device root differs from the host root")
            checked_members = HASH_MEMBERS
        else:  # a sample: the host tree at 1,024 leaves takes about 50 s
            host_digests = [m.hash(leaf_params) for m in members[:HASH_SAMPLE]]
            checked_members = HASH_SAMPLE
        if digests[:checked_members] != host_digests:
            raise AssertionError(f"{stack}: hash_batch differs from host Member.hash")
        if stack == "pedersen381":
            STATE["hash"] = (stack, leaf_params, node_params, members)
        r.update({"members": HASH_MEMBERS, "levels": len(tree.levels),
                  "first_s": runs[0]["s"], "s": runs[1]["s"],
                  "launches": runs[1]["launches"],
                  "k3_shapes": [{"field": f, "shape": list(a), "operand_b": list(b),
                                 "launches": n} for (f, a, b), n in k3_shapes.items()],
                  "host_checked_members": checked_members})
        log(f"hash {stack}: {HASH_MEMBERS} members + tree on the card {runs[0]['s']:.3f}s "
            f"first, {runs[1]['s']:.3f}s second, launches {runs[1]['launches']}; "
            + "".join(f"{k} {r[k]:.3f}s; " for k in ("params_s", "host_hash_s", "host_tree_s",
                                                     "host_tree_64_s") if k in r)
            + f"K3 at {len(k3_shapes)} shapes, operands copied by the wrapper at "
            f"{r['k3_copied_at'] or 'none'}; equal to the host")

    # entry(): eight two-to-one hashes on the card against the host
    fn, (left, right) = entry.entry()
    got = fs.limbs_to_ints(fn(left, right).cpu().numpy())
    node_params = entry._params()[2]
    nbytes = node_params.spec.n * 2
    want = [ph.two_to_one_host(node_params, a.to_bytes(nbytes, "little"),
                               b.to_bytes(nbytes, "little")).v
            for a, b in zip(fs.limbs_to_ints(left.cpu().numpy()),
                            fs.limbs_to_ints(right.cpu().numpy()))]
    if got != want:
        raise AssertionError("entry() on the card differs from two_to_one_host")
    out["entry"] = {"batch": len(got), "equal_to_host": True}

    out["proof"] = _hash_proof_run()

    # the harness at the reference's largest registrar, setup on the card
    t = time.time()
    rows = [json.loads(line) for line in _run_module(
        "zkmember_tpu_torch.app.bench_harness",
        ["--sizes", str(HASH_MEMBERS), "--systems", "groth16", "--reps", "1"]).splitlines()
        if line.startswith("{")]
    names = [row["name"] for row in rows]
    want_names = [f"bls12_381_groth16_{p}_{HASH_MEMBERS}" for p in
                  ("setup", "prove", "prove", "verify")]
    if names != want_names or rows[-1].get("verified") is not True:
        raise AssertionError(f"the {HASH_MEMBERS}-member harness rows {rows} are not "
                             f"{want_names} with a verified proof")
    out["harness"] = {"rows": rows, "wall_s": time.time() - t}
    log(f"harness at {HASH_MEMBERS} members: rows {names}, verified, "
        f"{out['harness']['wall_s']:.1f}s")

    # K3 at the widest te_add wave (the leaf hash's first round at 1,024
    # rows) and at the Fermat inverse's rows, both stacks' fields
    widest = (5, HASH_MEMBERS, 128)
    out["k3"] = [dict(time_k3(np_rng, spec, widest + (spec.n,), widest + (spec.n,)),
                      path=f"hash {stack} wave")
                 for stack, spec in (("pedersen381", fs.BLS_FR), ("pedersen761", fs.BW6_FR))]
    out["k3"] += [dict(time_k3(np_rng, spec, (HASH_MEMBERS, spec.n), (HASH_MEMBERS, spec.n)),
                       path=f"hash {stack} inverse")
                  for stack, spec in (("pedersen381", fs.BLS_FR), ("pedersen761", fs.BW6_FR))]
    for k in out["k3"]:
        key = (k["field"], tuple(k["shape"]), tuple(k["operand_b"]))
        stack = k["path"].split()[1]
        k["launches"] = sum(s["launches"] for s in out[stack]["k3_shapes"]
                            if (s["field"], tuple(s["shape"]), tuple(s["operand_b"])) == key)
    torch.cuda.synchronize()
    RESULTS["hash"] = out


def phase_scale(np_rng):
    """app.scale.run_depth(32): the depth-32 circuit (about 100k constraints,
    M = 2^17) through trace, setup on the card, warm, a first and a timed
    proof and verify; the launches of each phase; the proof rejected for a
    wrong leaf; one more proof with every kernel call held against its plain
    version; K1 and the finish timed at its shapes."""
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.app import scale
    from zkmember_tpu_torch.snark import groth16, prove_lm

    rows = []

    def out(line):  # each row ends a phase: its launches, then the counts start again
        row = json.loads(line)
        row["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        kernels.reset_launches()
        rows.append(row)
        log(f"scale {row['name']}: {row['seconds']} s; launches {row['launches']}"
            + "".join(f"; {k} {row[k]}" for k in ("constraints", "variables", "domain",
                                                     "verified") if k in row))

    kernels.reset_launches()
    keys, cs, public, proof = scale.run_depth(32, out=out, device="cuda")
    by = {r["name"].removeprefix("bls12_381_groth16_depth32_"): r for r in rows}
    if by["setup"]["launches"].get("mont_mul_bm", 0) == 0:
        raise AssertionError("the depth-32 setup launched no mont_mul_bm")
    expect = {"mont_mul": 3 * (keys.M.bit_length() - 1) + 6, "select_reduce_fp": 1,
              "select_reduce_fp2": 1, "msm_finish_fp": 2, "msm_finish_fp2": 2}
    if by["prove"]["launches"] != expect:
        raise AssertionError(f"the depth-32 proof launched {by['prove']['launches']}, not {expect}")
    if keys.M != 1 << 17 or by["verify"].get("verified") is not True:
        raise AssertionError(f"the depth-32 proof at M = {keys.M} did not verify")
    if groth16.verify(keys.pk.vk, [public[0], (public[1] + 1) % keys.cfg.r], proof):
        raise AssertionError("the depth-32 proof verifies for a wrong leaf")
    checked, k2_shapes, *_ = checked_run(lambda: prove_lm.prove(keys, cs), "depth-32 proof")
    if not groth16.verify(keys.pk.vk, public, checked):
        raise AssertionError("the checked depth-32 proof does not verify")
    if k2_shapes != k2_proof_shapes(keys.M):
        raise AssertionError(f"the depth-32 K2 shapes {k2_shapes} differ from "
                             f"{k2_proof_shapes(keys.M)}")
    RESULTS["scale"] = {"rows": rows, "M": keys.M, "constraints": cs.num_constraints,
                        "launches": by["prove"]["launches"],
                        "setup_launches": by["setup"]["launches"]}
    time_msm_kernels(np_rng, keys, 1, "depth 32", RESULTS["scale"]["launches"])
    RESULTS["scale"]["onthefly"] = _scale_onthefly(np_rng, keys, cs, public)
    STATE["scale"] = (keys, cs)
    log("scale: the depth-32 proof verifies, a wrong leaf is rejected, every kernel call "
        "of a checked proof equals its plain version")


def _scale_onthefly(np_rng, keys, cs, public) -> dict:
    """The on-the-fly route at depth 32 (M = 2^17, 4 M = 2^19 lanes of G1): a
    precompute=False key's proof, launches counted, equal to the table
    route's from the same rng and verified; msm_program_chunked over the
    key's G1 rows in 4 slices of 2^15 lanes (launches counted) equal, row
    for row, to one unsliced on-the-fly MSM (the default 2^18-lane slice
    never splits a row here); K1 and the finish timed at the slice's
    shapes beside their plain versions."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import rng as frng

    out: dict = {}
    okeys = prove_lm.Groth16KeysLM(keys.pk, "cuda", precompute=False)
    prove_lm.prove(okeys, cs, rng=frng.test_rng(32))  # warm-up
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    proof = prove_lm.prove(okeys, cs, rng=frng.test_rng(32))
    out["prove_s"] = time.time() - t
    out["launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if not _same_proof(proof, prove_lm.prove(keys, cs, rng=frng.test_rng(32))):
        raise AssertionError("the depth-32 on-the-fly proof differs from the table route's")
    if not groth16.verify(keys.pk.vk, public, proof):
        raise AssertionError("the depth-32 on-the-fly proof does not verify")
    log(f"scale: precompute=False proof in {out['prove_s']:.3f}s, launches {out['launches']}; "
        "equal to the table-route proof, verifies")
    del okeys

    B, S = keys.B1, 1 << 15
    z = _scalars_on_points(np_rng, fs.BLS_FR, keys.g1_X, keys.g1_Y)
    kernels.reset_launches()
    t = time.time()
    sliced = _to_numpy(straus.msm_program_chunked(keys.ops1, keys.g1_X, keys.g1_Y, z, keys.nwin,
                                                  max_lanes=S))
    out["chunked_s"] = time.time() - t
    out["chunked_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if (out["chunked_launches"].get("select_reduce_fp"), out["chunked_launches"].get(
            "msm_finish_fp")) != (B // S, 2 * B // S):
        raise AssertionError(f"the sliced MSM launched {out['chunked_launches']}")
    whole = _to_numpy(straus.msm_program_chunked(keys.ops1, keys.g1_X, keys.g1_Y, z, keys.nwin))
    g1 = keys.cfg.mod.G1
    for r in range(4):
        a, b = (straus.projective_to_host(g1, tuple(c[r] for c in P)) for P in (sliced, whole))
        if a is None or a != b:
            raise AssertionError(f"the sliced G1 MSM differs from the unsliced one at row {r}")
    log(f"scale: msm_program_chunked over 4 x {B} G1 lanes in {B // S} slices of {S} in "
        f"{out['chunked_s']:.3f}s ({out['chunked_launches']}), equal to one slice row for row")
    tab = straus.table_program(keys.ops1, keys.g1_X[..., :S], keys.g1_Y[..., :S])
    time_k1_finish(np_rng, keys.ops1, tab, keys.nwin, 1, 4, S, "depth 32 slice", "G1",
                   out["chunked_launches"])
    del tab
    out["memory"] = _table_memory(keys, cs)
    return out


def _table_memory(keys, cs) -> dict:
    """The basis of straus.table_budget at depth 32: the card's allocator
    around one build of the key's G1 table (its bytes, what stays
    allocated, the peak of the build) and around one table-route proof
    beside the kept tables (its peak: a proof's working set)."""
    import torch

    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.snark import prove_lm
    from zkmember_tpu_torch.utils import rng as frng

    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = fn()
        torch.cuda.synchronize()
        return kept, torch.cuda.memory_allocated() - base, torch.cuda.max_memory_allocated() - base

    tab, held, build_peak = peak_of(
        lambda: straus.table_program(keys.ops1, keys.g1_X, keys.g1_Y))
    del tab
    _, _, proof_peak = peak_of(lambda: prove_lm.prove(keys, cs, rng=frng.test_rng(32)))
    out = {"card_bytes": torch.cuda.get_device_properties(0).total_memory,
           "table_budget": straus.table_budget("cuda"),
           "g1_table_bytes": straus.table_bytes(keys.ops1, 4, keys.B1),
           "g1_table_allocated": held, "g1_build_peak": build_peak,
           "g2_table_bytes": straus.table_bytes(keys.ops2, 1, keys.B2g),
           "proof_peak": proof_peak}
    out["build_peak_over_table"] = build_peak / out["g1_table_bytes"]
    log(f"scale: table memory at M = {keys.M}: G1 table {out['g1_table_bytes']} bytes "
        f"({held} allocated), its build peaks {build_peak} bytes above the start "
        f"({out['build_peak_over_table']:.2f} x the table); a table-route proof peaks "
        f"{proof_peak} bytes above its start; the budget {out['table_budget']} of "
        f"{out['card_bytes']} bytes")
    if held != out["g1_table_bytes"]:
        raise AssertionError(f"the G1 table holds {held} bytes, not "
                             f"{out['g1_table_bytes']} (straus.table_bytes)")
    return out


# ---------------------------------------------------------------------------
# the second curve stack: pedersen761, Groth16 over BW6-761
# ---------------------------------------------------------------------------


def _bw6_key_matches(pk, loaded) -> None:
    """Raise unless a loaded key holds setup's key: every query plane limb for
    limb, the index lists, beta, delta and the verifying key."""
    import numpy as np

    from zkmember_tpu_torch.utils import checkpoint
    from zkmember_tpu_torch.utils import serialize as ser

    got, want = checkpoint.query_arrays(loaded), checkpoint.query_arrays(pk)
    if sorted(got) != sorted(want) or len(want) != 10:
        raise AssertionError(f"the loaded key's arrays {sorted(got)} are not setup's {sorted(want)}")
    for k in want:
        if got[k].shape != want[k].shape or not np.array_equal(got[k], want[k]):
            raise AssertionError(f"the loaded key's {k} differs from setup's")
    for attr in ("a_nonzero", "b_nonzero", "l_nonzero", "domain_size", "num_instance",
                 "beta_g1", "delta_g1"):
        if getattr(loaded, attr) != getattr(pk, attr):
            raise AssertionError(f"the loaded key's {attr} differs from setup's")
    if ser.vk_to_bytes(loaded.vk) != ser.vk_to_bytes(pk.vk):
        raise AssertionError("the loaded verifying key differs from setup's")


def phase_bw6(np_rng):
    """The pedersen761 stack end to end on the card: the 16-member BW6-761
    registrar and circuit (20,761 constraints, M = 2^15, Fr of 24 limbs,
    Fq of 48 for G1 and G2); setup on the card; the key saved and loaded
    back; a timed prove_lm proof through K1 and the finish at n = 48, K2
    and no other kernel; verify and the tampered proofs; phases; a checked
    table build and proof (every kernel call against its plain version);
    the v1 proof equal to prove_lm's; a batch of 4 equal to 4 sequential
    proofs; K1 and the finish timed at the proof's shapes and at P = 4;
    the bench harness and the CLI with --stack pedersen761 in
    subprocesses."""
    import random
    import tempfile

    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.snark import groth16, prove_lm
    from zkmember_tpu_torch.utils import checkpoint

    stack, curve = "pedersen761", "bw6_761"
    out: dict = {}
    cs, public, rng = _membership_circuit(16, stack)
    if (cs.num_constraints, cs.num_variables) != (20761, 20757):
        raise AssertionError(f"the BW6-761 circuit has {cs.num_constraints} constraints and "
                             f"{cs.num_variables} variables, not the reference's 20,761 and 20,757")
    log(f"bw6 circuit: {cs.num_constraints} constraints, {cs.num_variables} vars")

    kernels.reset_launches()
    torch.cuda.synchronize()
    phases: dict = {}
    t = time.time()
    pk, vk = groth16.setup(cs, curve, rng, device="cuda", phase_times=phases)
    out["setup"] = {"setup_s": time.time() - t, **phases}
    out["setup_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if out["setup_launches"].get("mont_mul_bm", 0) == 0 or pk.domain_size != BW6_M:
        raise AssertionError(f"the BW6-761 setup launched {out['setup_launches']} at "
                             f"M = {pk.domain_size}")
    log(f"bw6 setup in {out['setup']['setup_s']:.2f}s (phases synchronized): " + ", ".join(
        f"{k} {v:.3f}s" for k, v in phases.items()) + f"; launches {out['setup_launches']}")
    state = rng.getstate()  # what the proofs below draw r and s from

    tmp = tempfile.TemporaryDirectory(dir=REPO, prefix=".bw6_")
    try:
        ck = os.path.join(tmp.name, f"groth16_{curve}_16")
        t = time.time()
        checkpoint.save_groth16_keys(ck, pk)
        keys = checkpoint.load_groth16_keys(ck, device="cuda")
        _bw6_key_matches(pk, keys.pk)
        out["save_load_s"] = time.time() - t
        log(f"bw6 key saved and loaded back in {out['save_load_s']:.1f}s: the same key")
        t = time.time()
        prove_lm.warm(keys)
        out["keys_warm_s"] = time.time() - t
        log(f"bw6 keys: M={keys.M}, G1 lanes 4x{keys.B1}, G2 lanes {keys.B2g}, {keys.nwin} "
            f"windows, b3 {keys.ops1.b3} / {keys.ops2.b3}; warm in {out['keys_warm_s']:.1f}s")
        t = time.time()
        prove_lm.prove(keys, cs, rng=_rng_at(state))
        log(f"bw6 warm-up proof in {time.time() - t:.2f}s")

        torch.cuda.synchronize()
        t = time.time()
        proof, k1_shapes, fin_shapes, _, _ = _launches_by_shape(
            lambda: prove_lm.prove(keys, cs, rng=_rng_at(state)))
        out["prove_s"] = time.time() - t
        launches = dict(kernels.LAUNCHES)
        counted = _k1_finish_launches(k1_shapes, fin_shapes)
        expect = dict.fromkeys(kernels.LAUNCHES, 0)
        expect.update({"mont_mul": 3 * (keys.M.bit_length() - 1) + 6, "select_reduce_fp48": 2,
                       "msm_finish_fp48": 4})
        log(f"bw6 timed proof in {out['prove_s']:.3f}s; launches {launches}")
        if launches != expect:
            raise AssertionError(f"the BW6-761 proof launched {launches}, not {expect}")
        out["launches"] = launches

        _holds_and_tamper_fails(keys.cfg, vk, public, proof, "BW6-761 proof")

        out["breakdown"] = traced_proof(
            lambda phases: prove_lm.prove(keys, cs, rng=_rng_at(state), phase_times=phases),
            "bw6 proof", LM_PHASES, proof, vk, public)
        log("bw6 phases of a proof synchronized at each phase: " + ", ".join(
            f"{k} {v:.3f}s" for k, v in out["breakdown"].items()))

        # every kernel call held against its plain version: the per-key table
        # build (K2 at n = 48), then a proof (K2 at n = 24, K1 and the finish
        # at n = 48 for G1 and G2)
        fresh = prove_lm.Groth16KeysLM(keys.pk, "cuda")
        _, k2_tables, *_ = checked_run(fresh.build_tables, "bw6 table build")
        del fresh
        if {f for f, _, _ in k2_tables} != {fs.BW6_FQ.name}:
            raise AssertionError(f"the BW6-761 table build ran K2 at {sorted(k2_tables)}")
        checked, k2_shapes, *_ = checked_run(
            lambda: prove_lm.prove(keys, cs, rng=_rng_at(state)), "bw6 proof")
        if not _same_proof(checked, proof):
            raise AssertionError("the checked BW6-761 proof differs from the timed one")
        if k2_shapes != k2_proof_shapes(keys.M, 1, fs.BW6_FR):
            raise AssertionError(f"the BW6-761 proof's K2 shapes {k2_shapes} differ from "
                                 f"{k2_proof_shapes(keys.M, 1, fs.BW6_FR)}")
        out["k2_table_shapes"] = [[list(a), list(b), k] for (_, a, b), k in k2_tables.items()]

        # the v1 (batch-major) prover on setup's key, from the same rng state;
        # then one more with K3 held against its plain version at every
        # distinct shape (BW6-761 Fr at n = 24, Fq at n = 48)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t = time.time()
        v1 = groth16.prove(pk, cs, rng=_rng_at(state), device="cuda")
        out["prove_v1_s"] = time.time() - t
        out["launches_v1"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
        if set(out["launches_v1"]) != {"mont_mul_bm"}:
            raise AssertionError(f"the BW6-761 v1 proof launched {out['launches_v1']}")
        if not _same_proof(v1, proof):
            raise AssertionError("the BW6-761 v1 proof differs from prove_lm's with the same "
                                 "keys and rng state")
        log(f"bw6 v1 proof in {out['prove_v1_s']:.2f}s ({out['launches_v1']['mont_mul_bm']} K3 "
            "launches) equals the prove_lm proof")
        if not _same_proof(checked_v1_proof(pk, cs, _rng_at(state)), v1):
            raise AssertionError("the checked BW6-761 v1 proof differs from the timed one")

        # a batch of 4 distinct members equals 4 sequential proofs
        idxs = random.Random(1).sample(range(16), BATCH_CHECKED)
        circuits = [_member_circuit(16, i, stack) for i in idxs]
        _, out["prove_batch_s"], out["launches_batch"], batch_counted = _batch_equals_sequential(
            keys, circuits, state, f"BW6-761 batch (members {idxs})")
        if out["launches_batch"] != expect:
            raise AssertionError(f"the BW6-761 batch launched {out['launches_batch']}, "
                                 f"not {expect}")
        STATE["bw6"] = (keys, cs, _rng_at(state))

        time_msm_kernels(np_rng, keys, 1, "bw6 proof", launches, counted)
        time_msm_kernels(np_rng, keys, BATCH_CHECKED, f"bw6 batch of {BATCH_CHECKED}",
                         out["launches_batch"], batch_counted)

        # the harness on the saved key, in a subprocess
        t = time.time()
        rows = [json.loads(line) for line in _run_module(
            "zkmember_tpu_torch.app.bench_harness",
            ["--stack", stack, "--sizes", "16", "--checkpoint-dir", tmp.name, "--reps", "3"],
        ).splitlines() if line.startswith("{")]
        out["harness"] = {"rows": rows, "wall_s": time.time() - t}
        names = [r["name"] for r in rows]
        want = (["bw6_761_groth16_setup_load_16"] + ["bw6_761_groth16_prove_16"] * 4
                + ["bw6_761_groth16_verify_16"])
        if names != want or rows[-1].get("verified") is not True:
            raise AssertionError(f"the pedersen761 harness rows {rows} are not {want}, verified")
        log(f"bw6 harness: rows {names}, verified")
    finally:
        tmp.cleanup()

    out["cli_s"] = _cli_members(stack, 4, 2, 2)
    RESULTS["bw6"] = out


# ---------------------------------------------------------------------------
# Marlin over KZG: universal setup, index, prove, verify
# ---------------------------------------------------------------------------


def marlin_k2_shapes(n_h: int, n_k: int, fr) -> dict:
    """K2's operand shapes in one Marlin proof at |H| = n_h, |K| = n_k (all
    its transforms on the device route), each with its launches: log2 N
    butterfly stages of each NTT, one 1/N product a inverse NTT (PolyEngine
    over ntt/lm.py): 4 inverse at |H|, 5 forward and 1 inverse at 4|H|, 9
    forward and 1 inverse at |K|, 10 coset forward and 1 inverse at 8|K|."""
    n = fr.n
    transforms = ([(n_h, True)] * 4 + [(4 * n_h, False)] * 5 + [(4 * n_h, True)]
                  + [(n_k, False)] * 9 + [(n_k, True)] + [(8 * n_k, False)] * 10
                  + [(8 * n_k, True)])
    out: dict = {}
    for N, inverse in transforms:
        stage = (fr.name, (n, N // 2), (n, N // 2))
        out[stage] = out.get(stage, 0) + N.bit_length() - 1
        if inverse:
            scale = (fr.name, (n, N), (n, 1))
            out[scale] = out.get(scale, 0) + 1
    return out


def _marlin_parts(proof):
    """A Marlin proof's commitments, evaluations and witnesses, comparable."""
    comms = [(c.c, c.shifted) for c in proof.comms1 + proof.comms2 + proof.comms3]
    return (comms, proof.sigma3, proof.evals_beta1, proof.evals_beta2, proof.proof_beta1.w,
            proof.proof_beta2.w)


def _marlin_holds(ivk, public, proof, other_leaf, r: int, what: str) -> None:
    """Raise unless `proof` verifies for `public` (root, leaf) and fails for a
    wrong root (root + 1) and for another member's leaf."""
    from zkmember_tpu_torch.snark import marlin

    if not marlin.verify(ivk, public, proof):
        raise AssertionError(f"the {what} does not verify")
    if marlin.verify(ivk, [(public[0] + 1) % r, public[1]], proof):
        raise AssertionError(f"the {what} verifies for a wrong root")
    if marlin.verify(ivk, [public[0], other_leaf], proof):
        raise AssertionError(f"the {what} verifies for another member's leaf")
    log(f"{what} verifies; a wrong root and another member's leaf are rejected")


def _marlin_run(stack: str, members: int, out: dict, timed: bool):
    """Universal setup, index, a first proof (it builds the domains' twiddle
    tables) and, with `timed`, one more proof, each with the launch counts
    reset just before it and read just after, on the `members`-member
    registrar of `stack`.  Fills `out`; returns (pp, ipk, ivk, cs, public,
    other_leaf, state, proof, counted): `counted` maps each K1 digit shape
    of the last of those proofs to its launches of K1 and the finish
    (``_k1_finish_launches``)."""
    import torch

    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.app import bench_harness
    from zkmember_tpu_torch.snark import groth16, kzg, marlin
    from zkmember_tpu_torch.utils import rng as frng

    curve = bench_harness.CURVES[stack]
    cs, public, _ = _membership_circuit(members, stack)
    digests = _registrar(members, stack)[3]
    other_leaf = next(d for d in digests if d != public[1])
    nc, nv, nnz = cs.num_constraints, cs.num_variables, bench_harness._nnz(cs)
    rng = frng.test_rng()
    kernels.reset_launches()
    torch.cuda.synchronize()
    phases: dict = {}
    t = time.time()
    pp = marlin.universal_setup(nc, nv, nnz, curve=curve, rng=rng, device="cuda",
                                phase_times=phases)
    out["setup_s"] = time.time() - t
    out["setup_phases"] = phases
    out["setup_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    phases = {}
    t = time.time()
    ipk, ivk = marlin.index(pp, cs, device="cuda", phase_times=phases)
    out["index_s"] = time.time() - t
    out["index_phases"] = phases
    out["index_launches"] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    info = ipk.info
    out.update(constraints=nc, variables=nv, nnz=nnz, n_h=info.n_h, n_k=info.n_k,
               max_degree=pp.max_degree, lanes=kzg.table_lanes(pp.max_degree))
    out["table_rows"] = -(-(pp.max_degree + 1) // out["lanes"])
    log(f"marlin {stack} {members} members: {nc} constraints, {nv} vars, nnz {nnz}, "
        f"|H| {info.n_h}, |K| {info.n_k}, SRS degree {pp.max_degree} "
        f"({out['table_rows']} rows of {out['lanes']}); setup {out['setup_s']:.2f}s "
        f"({out['setup_launches']}), index {out['index_s']:.2f}s "
        f"({out['index_launches']}; {phases})")
    state = rng.getstate()
    t = time.time()
    proof, k1_shapes, fin_shapes, _, out["first_launches"] = _launches_by_shape(
        lambda: marlin.prove(ipk, cs, rng=_rng_at(state), device="cuda"))
    out["first_prove_s"] = time.time() - t
    log(f"marlin {stack} first proof (the domains' twiddle tables) in "
        f"{out['first_prove_s']:.2f}s; launches {out['first_launches']}")
    if timed:
        torch.cuda.synchronize()
        t = time.time()
        again, k1_shapes, fin_shapes, _, _ = _launches_by_shape(
            lambda: marlin.prove(ipk, cs, rng=_rng_at(state), device="cuda"))
        out["prove_s"] = time.time() - t
        out["launches"] = dict(kernels.LAUNCHES)
        log(f"marlin {stack} timed proof in {out['prove_s']:.3f}s; launches {out['launches']}")
        if _marlin_parts(again) != _marlin_parts(proof):
            raise AssertionError("two Marlin proofs from the same rng state differ")
    counted = _k1_finish_launches(k1_shapes, fin_shapes)
    out["k1_finish_shapes"] = [[list(k), v] for k, v in counted.items()]
    t = time.time()
    marlin.verify(ivk, public, proof)
    out["verify_s"] = time.time() - t
    _marlin_holds(ivk, public, proof, other_leaf, groth16.pairing_config(curve).r,
                  f"{stack} Marlin proof")
    return pp, ipk, ivk, cs, public, other_leaf, state, proof, counted


def _marlin_checked_setup_index(stack: str, pp, ivk, cs, what: str):
    """One more universal setup (test_rng(), as the first) and index of `cs`
    under checked_run: they must give the same SRS powers and the same
    matrix commitments as `pp` and `ivk`.  Returns K3's launches of the
    setup by shape and K1's digit shapes of the index."""
    from zkmember_tpu_torch.app import bench_harness
    from zkmember_tpu_torch.snark import marlin
    from zkmember_tpu_torch.utils import rng as frng

    fresh, _, _, k3_setup, _ = checked_run(lambda: marlin.universal_setup(
        cs.num_constraints, cs.num_variables, bench_harness._nnz(cs),
        curve=bench_harness.CURVES[stack], rng=frng.test_rng(), device="cuda"),
        f"{what} setup")
    for a, b in ((fresh.powers.x, pp.powers.x), (fresh.powers.y, pp.powers.y)):
        if not bool((a == b).all()):
            raise AssertionError(f"the checked {what} setup gives another SRS")
    (_, ivk2), _, k1_index, *_ = checked_run(lambda: marlin.index(fresh, cs, device="cuda"),
                                            f"{what} index")
    for name in marlin.MATRICES:
        got = [(c.c, c.shifted) for c in ivk2.matrix_comms[name]]
        if got != [(c.c, c.shifted) for c in ivk.matrix_comms[name]]:
            raise AssertionError(f"the checked {what} index's {name} commitments differ")
    log(f"checked {what} setup and index: the same SRS and matrix commitments")
    return k3_setup, [list(k) for k in k1_index]


def _launches_by_shape(run):
    """run() with the launch counts set to 0 just before it, and each
    launch of K1, the finish and K2 counted by shape where its wrapper
    launches it (the rise of its count across the wrapper's call), nothing
    held: K1 by (variant, digit shape), the finish by (variant, (W, rows,
    NT)) as time_k1_finish views it, K2 by (field, shape of a, shape of
    b).  Raises unless each kernel's counts by shape add up to its count
    of the run.  Returns run()'s result, the three counts and the run's
    launches."""
    from zkmember_tpu_torch import kernels
    from zkmember_tpu_torch.fields import lm_cuda
    from zkmember_tpu_torch.msm import finish_cuda as fin, select_reduce_cuda as k1

    launch = k1.select_reduce_cuda, fin.msm_finish_cuda, lm_cuda.mont_mul_cuda
    by_shape: dict = {}  # (counter name, shape key) -> launches

    def counted(fn, key_of):
        def wrapper(*args):
            before = dict(kernels.LAUNCHES)
            out = fn(*args)
            for name, v in kernels.LAUNCHES.items():
                if v != before[name]:
                    key = (name, key_of(*args))
                    by_shape[key] = by_shape.get(key, 0) + v - before[name]
            return out
        return wrapper

    def finish_key(ops, S):
        c = S[0][0] if isinstance(S[0], tuple) else S[0]
        return (c.shape[0], c.shape[1], c.shape[3]) if c.ndim == 4 else tuple(c.shape)

    k1.select_reduce_cuda = counted(launch[0], lambda ops, tab, digits: tuple(digits.shape))
    fin.msm_finish_cuda = counted(launch[1], finish_key)
    lm_cuda.mont_mul_cuda = counted(
        launch[2], lambda spec, a, b: (spec.name, tuple(a.shape), tuple(b.shape)))
    kernels.reset_launches()
    try:
        result = run()
    finally:
        k1.select_reduce_cuda, fin.msm_finish_cuda, lm_cuda.mont_mul_cuda = launch
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    for name, v in launches.items():
        if name != "mont_mul_bm" and sum(n for (c, _), n in by_shape.items() if c == name) != v:
            raise AssertionError(f"{name}'s launches by shape {by_shape} do not add up to {v}")
    k1_shapes = {(c, k): n for (c, k), n in by_shape.items() if c.startswith("select_reduce")}
    fin_shapes = {(c, k): n for (c, k), n in by_shape.items() if c.startswith("msm_finish")}
    k2_shapes = {k: n for (c, k), n in by_shape.items() if c == "mont_mul"}
    return result, k1_shapes, fin_shapes, k2_shapes, launches


def _k1_finish_launches(k1_shapes: dict, fin_shapes: dict) -> dict:
    """K1's digit shapes (W, P, R, B) of one counted run -> the launches
    of K1 there and of the finish at the window sums that K1 call gives,
    (W, P R, NT), both from ``_launches_by_shape``: {K1 variant: n, finish
    variant: m}.  Raises unless each finish shape comes from one K1 shape."""
    from zkmember_tpu_torch.msm import select_reduce_cuda as k1

    out, fed = {}, []
    for (name, (W, P, R, B)), n in sorted(k1_shapes.items(), key=lambda kv: kv[0][1][::-1]):
        fkey = (name.replace("select_reduce", "msm_finish"), (W, P * R, B // k1.tile_shape(B)[1]))
        fed.append(fkey)
        out[(W, P, R, B)] = {name: n, fkey[0]: fin_shapes.get(fkey, 0)}
    if len(set(fed)) != len(fed) or set(fed) != set(fin_shapes):
        raise AssertionError(f"the finish's shapes {sorted(fin_shapes)} are not one to each of "
                             f"K1's {sorted(k1_shapes)}")
    return out


def _marlin_budget_run(np_rng, ipk, ivk, cs, public, state, proof, k2_table: dict) -> dict:
    """KZG past its lane budget on the 16-member BLS12-381 Marlin key: the
    SRS with a budget of D lanes (below D + 1 powers) and no table, a warm
    proof with the launch counts reset just before it and read just after
    (each commitment through straus.msm_program: its own table, K1, the
    finish); the proof and every commitment in it equal the table route's
    from the same rng state, and it verifies.  Then K1 and the finish at
    each of its digit shapes, on random digits against a table of the SRS
    powers, and K2 at each of its operand shapes of 16,384 lanes or more
    that the table route's proof (`k2_table`) does not have: each held
    against its plain version and timed beside it."""
    import dataclasses

    import torch

    from zkmember_tpu_torch.msm import straus
    from zkmember_tpu_torch.snark import groth16, marlin, prove_lm

    pp = ipk.pp
    bpp = dataclasses.replace(pp, max_tab_lanes=pp.max_degree, table=None)
    bipk = dataclasses.replace(ipk, pp=bpp)
    torch.cuda.synchronize()
    t = time.time()
    bproof, k1_shapes, fin_shapes, k2_shapes, launches = _launches_by_shape(
        lambda: marlin.prove(bipk, cs, rng=_rng_at(state), device="cuda"))
    at = _k1_finish_launches(k1_shapes, fin_shapes)
    out = {"prove_s": time.time() - t, "max_tab_lanes": bpp.max_tab_lanes,
           "launches": launches, "k1_finish_shapes": [[list(k), v] for k, v in at.items()]}
    log(f"marlin past the KZG budget ({bpp.max_tab_lanes} lanes < {pp.max_degree + 1} powers): "
        f"proof in {out['prove_s']:.3f}s, launches {launches}, K1 and the finish at {at}")
    if bpp.table is not None:
        raise AssertionError("the KZG budget route built an SRS table")
    if _marlin_parts(bproof) != _marlin_parts(proof):
        raise AssertionError("the Marlin proof past the KZG budget differs from the table route's")
    if not marlin.verify(ivk, public, bproof):
        raise AssertionError("the Marlin proof past the KZG budget does not verify")
    log("marlin past the KZG budget: every commitment and the proof equal the table route's; "
        "it verifies")
    ops = prove_lm.sw_ops(groth16.pairing_config(pp.curve), False, "cuda")
    D1 = pp.max_degree + 1
    for (W, P, R, B), counts in at.items():
        X, Y = (torch.nn.functional.pad(c[: min(B, D1)].T, (0, B - min(B, D1)))
                for c in (pp.powers.x, pp.powers.y))
        time_k1_finish(np_rng, ops, straus.table_program(ops, X, Y), W, P, R, B,
                       "marlin past the KZG budget", "G1", counts)
    new = {key: k for key, k in k2_shapes.items() if key not in k2_table and key[1][-1] >= 1 << 14}
    out["mont_mul_shapes"] = time_k2(np_rng, new, None, "marlin past the KZG budget")
    return out


def phase_marlin(np_rng):
    """Marlin over KZG on the card: the 16-member BLS12-381 registrar (the
    prove phase's; |H| = 2^14, |K| = 2^15, SRS degree 196,608) through
    universal setup, index, a first and a timed proof (launches counted:
    K2, K1 and the finish only), proof phases, verify against a wrong root
    and another leaf, zero knowledge (another rng, other commitments); one
    more setup, index and proof with every kernel call held against its
    plain version; K1 and the finish timed at the proof's commit shapes,
    K2 at its NTT shapes, K3 at setup's; then the pedersen761 registrar of
    MARLIN_BW6_MEMBERS (BW6-761: K1 and the finish at n = 48) checked the
    same way; then the bench harness's Marlin modes in subprocesses."""
    import random

    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.snark import groth16, kzg, marlin, prove_lm

    out: dict = {}
    pp, ipk, ivk, cs, public, other_leaf, state, proof, counted = _marlin_run(
        "pedersen381", 16, out, timed=True)
    info = ipk.info
    if (info.n_h, info.n_k, pp.max_degree) != (1 << 14, 1 << 15, 196_608):
        raise AssertionError(f"the 16-member Marlin index has |H| {info.n_h}, |K| {info.n_k}, "
                             f"SRS degree {pp.max_degree}, not 2^14, 2^15, 196,608")
    launches = out["launches"]
    want = dict.fromkeys(launches, 0)
    want.update(mont_mul=sum(marlin_k2_shapes(info.n_h, info.n_k, fs.BLS_FR).values()),
                select_reduce_fp=4, msm_finish_fp=8)  # rounds 1-3 and the openings
    if launches != want:
        raise AssertionError(f"the Marlin proof launched {launches}, not {want}")
    if out["setup_launches"].get("mont_mul_bm", 0) == 0:
        raise AssertionError(f"the Marlin setup launched {out['setup_launches']}")

    phases: dict = {}
    t = time.time()
    marlin.prove(ipk, cs, rng=_rng_at(state), device="cuda", phase_times=phases)
    out["breakdown"] = {"total_s": time.time() - t, **phases}
    log("marlin phases of a proof synchronized at each phase: " + ", ".join(
        f"{k} {v:.3f}s" for k, v in out["breakdown"].items()))

    other = marlin.prove(ipk, cs, rng=random.Random(2), device="cuda")
    if other.comms1[0].c == proof.comms1[0].c or other.comms1[1].c == proof.comms1[1].c:
        raise AssertionError("another rng gives the same w_hat or z_A commitment")
    if not marlin.verify(ivk, public, other):
        raise AssertionError("the Marlin proof from another rng does not verify")
    log("marlin: another rng gives other w_hat and z_A commitments, and verifies")

    # every kernel call held against its plain version: a fresh setup and its
    # index equal to the first (K3 at setup's fixed-base waves; the table
    # build's K2 at Fq, K2 at the inverse NTTs of |K|, K1 and the finish at
    # the matrix commitments' rows), then a proof
    k3_setup, out["index_k1_shapes"] = _marlin_checked_setup_index(
        "pedersen381", pp, ivk, cs, "marlin")
    checked, k2_shapes, k1_shapes, *_ = checked_run(
        lambda: marlin.prove(ipk, cs, rng=_rng_at(state), device="cuda"), "marlin proof")
    if _marlin_parts(checked) != _marlin_parts(proof):
        raise AssertionError("the checked Marlin proof differs from the timed one")
    if k2_shapes != marlin_k2_shapes(info.n_h, info.n_k, fs.BLS_FR):
        raise AssertionError(f"the Marlin proof's K2 shapes {k2_shapes} differ from "
                             f"{marlin_k2_shapes(info.n_h, info.n_k, fs.BLS_FR)}")
    out["k1_shapes"] = [[list(k), v] for k, v in k1_shapes.items()]
    if set(k1_shapes) != set(counted):
        raise AssertionError(f"the checked Marlin proof's K1 shapes {sorted(k1_shapes)} differ "
                             f"from the timed proof's {sorted(counted)}")

    # times: K1 and the finish at each commit shape of the proof (with the
    # timed proof's launches there), K2 at its NTT shapes, K3 at setup's
    # most launched shape
    tab = kzg._powers_tab(pp, kzg.table_lanes(pp.max_degree))  # built by the index
    ops = prove_lm.sw_ops(groth16.pairing_config("bls12_381"), False, "cuda")
    for (W, P, R, B), counts in counted.items():
        time_k1_finish(np_rng, ops, tab, W, P, R, B, "marlin proof", "G1", counts)
    out["mont_mul_shapes"] = time_k2(np_rng, k2_shapes, None, "marlin proof")
    (_, a3, b3), k3n = max(k3_setup.items(), key=lambda kv: kv[1])
    out["mont_mul_bm"] = dict(time_k3(np_rng, fs.BLS_FQ, a3, b3), path="marlin setup",
                              launches=out["setup_launches"]["mont_mul_bm"],
                              launches_at_shape=k3n)
    out["k3_setup_shapes"] = [[f, list(a), list(b), v] for (f, a, b), v in k3_setup.items()]
    STATE["marlin"] = (ipk, cs, state)
    out["budget"] = _marlin_budget_run(np_rng, ipk, ivk, cs, public, state, proof, k2_shapes)

    # BW6-761: K1 and the finish at n = 48, K2 at BW6-761 Fr (n = 24)
    bw6: dict = {}
    bpp, bipk, bivk, bcs, _, _, bstate, bproof, bcounted = _marlin_run(
        "pedersen761", MARLIN_BW6_MEMBERS, bw6, timed=False)
    binfo = bipk.info
    want = {"mont_mul": sum(marlin_k2_shapes(binfo.n_h, binfo.n_k, fs.BW6_FR).values()),
            "select_reduce_fp48": 4, "msm_finish_fp48": 8}
    if bw6["first_launches"] != want:
        raise AssertionError(f"the BW6-761 Marlin proof launched {bw6['first_launches']}, "
                             f"not {want}")
    bk3, bw6["index_k1_shapes"] = _marlin_checked_setup_index(
        "pedersen761", bpp, bivk, bcs, "bw6 marlin")
    bw6["k3_setup_shapes"] = [[f, list(a), list(b), v] for (f, a, b), v in bk3.items()]
    bchecked, _, bk1, *_ = checked_run(
        lambda: marlin.prove(bipk, bcs, rng=_rng_at(bstate), device="cuda"), "bw6 marlin proof")
    if _marlin_parts(bchecked) != _marlin_parts(bproof):
        raise AssertionError("the checked BW6-761 Marlin proof differs from the first")
    bw6["k1_shapes"] = [[list(k), v] for k, v in bk1.items()]
    if set(bk1) != set(bcounted):
        raise AssertionError(f"the checked BW6-761 Marlin proof's K1 shapes {sorted(bk1)} "
                             f"differ from the first proof's {sorted(bcounted)}")
    # K1 and the finish at n = 48 timed on the checked proof's inputs, with
    # the first proof's launches at each shape
    bops = prove_lm.sw_ops(groth16.pairing_config("bw6_761"), False, "cuda")
    for (W, P, R, B), counts in bcounted.items():
        time_k1_finish(np_rng, bops, None, W, P, R, B, "bw6 marlin proof", "G1", counts)
    out["bw6"] = bw6
    del bpp, bipk, bivk

    # the harness's Marlin modes in subprocesses, on both stacks
    out["harness"] = {}
    for label, args, want_names in (
        ("marlin", ["--systems", "marlin", "--sizes", "16", "--reps", "1"],
         ["setup+index_16", "prove_16", "prove_16", "verify_16"]),
        ("universal", ["--systems", "marlin", "--universal", "--sizes", "4,16", "--reps", "1"],
         ["setup+index_16", "prove_4", "verify_4", "prove_16", "verify_16"]),
        ("bw6", ["--stack", "pedersen761", "--systems", "marlin", "--sizes",
                 str(MARLIN_BW6_MEMBERS), "--reps", "1"],
         [f"setup+index_{MARLIN_BW6_MEMBERS}", f"prove_{MARLIN_BW6_MEMBERS}",
          f"prove_{MARLIN_BW6_MEMBERS}", f"verify_{MARLIN_BW6_MEMBERS}"]),
    ):
        t = time.time()
        rows = [json.loads(line) for line in
                _run_module("zkmember_tpu_torch.app.bench_harness", args).splitlines()
                if line.startswith("{")]
        system = "marlin_universal" if label == "universal" else "marlin"
        curve = "bw6_761" if label == "bw6" else "bls12_381"
        names = [r["name"] for r in rows]
        if names != [f"{curve}_{system}_{n}" for n in want_names]:
            raise AssertionError(f"the harness's {label} rows {names} are not {want_names}")
        if not [r for r in rows if "_verify_" in r["name"]] or not all(
                r.get("verified") is True for r in rows if "_verify_" in r["name"]):
            raise AssertionError(f"a harness {label} proof does not verify: {rows}")
        out["harness"][label] = {"rows": rows, "wall_s": time.time() - t}
        log(f"harness {label}: rows {names}, verified")
    RESULTS["marlin"] = out


PHASES = ("device", "build", "k2", "k1", "prove", "options", "multi", "k3", "setup", "prove_v1",
          "cli", "prove_batch", "harness", "bench", "hash", "scale", "bw6", "marlin")


def bench_line() -> str:
    """The bench phase's stdout line."""
    return json.dumps({
        "metric": "bench_cuda_groth16_bls12_381", **RESULTS["bench"],
        "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
    })


def hash_line() -> str:
    """The hash phase's stdout line."""
    return json.dumps({
        "metric": "pedersen_hash_merkle_1024members", **RESULTS["hash"],
        "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
    })


def options_line() -> str:
    """The options phase's stdout line."""
    return json.dumps({
        "metric": "groth16_bls12_381_options_16members", **RESULTS["options"],
        "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
    })


def multi_line() -> str:
    """The multi phase's stdout line."""
    return json.dumps({
        "metric": "groth16_bls12_381_sharded_16members", **RESULTS["multi"],
        "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
    }, default=str)


def marlin_line() -> str:
    """The Marlin phase's stdout line."""
    return json.dumps({
        "metric": "marlin_bls12_381_16members", **RESULTS["marlin"],
        "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
    })


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import random

    import numpy as np

    np_rng = np.random.default_rng(args.seed)
    py_rng = random.Random(args.seed)
    for name in phases:
        PLAIN_RUNS.clear()  # a phase times kernels only on inputs it held itself
        if name not in ("device", "build"):
            _release_card()
            log(f"phase {name} (card memory allocated "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
        else:
            log(f"phase {name}")
        if name == "device":
            phase_device()
        elif name == "build":
            phase_build()
        elif name == "k2":
            phase_k2(np_rng)
        elif name == "k1":
            phase_k1(np_rng, py_rng)
        elif name == "prove":
            phase_prove(np_rng)
        elif name == "options":
            phase_options(np_rng)
        elif name == "multi":
            phase_multi(np_rng)
        elif name == "k3":
            phase_k3(np_rng)
        elif name == "setup":
            phase_setup()
        elif name == "prove_v1":
            phase_prove_v1()
        elif name == "cli":
            phase_cli()
        elif name == "prove_batch":
            phase_prove_batch(np_rng)
        elif name == "harness":
            phase_harness()
        elif name == "bench":
            phase_bench()
        elif name == "bench_sweep":
            phase_bench_sweep()
        elif name == "hash":
            phase_hash(np_rng)
        elif name == "scale":
            phase_scale(np_rng)
        elif name == "bw6":
            phase_bw6(np_rng)
        elif name == "marlin":
            phase_marlin(np_rng)
        elif name == "profile":
            phase_profile()
        else:
            raise ValueError(f"unknown phase {name}")

    if set(PHASES) <= set(phases):
        from zkmember_tpu_torch import kernels

        print(json.dumps({
            "metric": "groth16_bls12_381_prove_16members",
            "prove_s": RESULTS["prove_s"],
            "phases_s": RESULTS["breakdown"],
            "device": RESULTS["device"],
            "nvidia_smi": RESULTS["smi"],
        }))
        print(options_line())
        print(multi_line())
        print(json.dumps({
            "metric": "groth16_bls12_381_setup_prove_v1_16members",
            "setup_s": RESULTS["setup"], "prove_v1_s": RESULTS["prove_v1_s"],
            "phases_s": RESULTS["breakdown_v1"], "cli_s": RESULTS["cli_s"],
            "mont_mul_bm_launches": {"setup": RESULTS["launches_setup"]["mont_mul_bm"],
                                     "prove_v1": RESULTS["launches_v1"]["mont_mul_bm"]},
            "mont_mul_bm_shapes": RESULTS["mont_mul_bm_shapes"],
            "mont_mul_shapes": RESULTS["mont_mul_shapes"],
            "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
        }))
        print(json.dumps({
            "metric": "groth16_bls12_381_prove_batch_harness_depth32",
            "prove_batch": RESULTS["prove_batch"], "harness": RESULTS["harness"],
            "scale": RESULTS["scale"],
            "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
        }))
        print(json.dumps({
            "metric": "groth16_bw6_761_pedersen761_16members", **RESULTS["bw6"],
            "device": RESULTS["device"], "nvidia_smi": RESULTS["smi"],
        }))
        print(bench_line())
        print(hash_line())
        print(marlin_line())
        print(json.dumps({"trace": TRACES}))
        print(RESULTS["smi"])
        sources = {
            "mont_mul": ("zkmember_tpu_torch/csrc/mont_mul.cu",
                         "zkmember_tpu/fields/lm_pallas.py:209"),
            "select_reduce_fp": ("zkmember_tpu_torch/csrc/select_reduce.cu",
                                 "zkmember_tpu/msm/pallas_msm.py:268"),
            "select_reduce_fp2": ("zkmember_tpu_torch/csrc/select_reduce.cu",
                                  "zkmember_tpu/msm/pallas_msm.py:268"),
            "mont_mul_bm": ("zkmember_tpu_torch/csrc/mont_mul_bm.cu",
                            "zkmember_tpu/fields/pallas_field.py:279"),
            "msm_finish_fp": ("zkmember_tpu_torch/csrc/msm_finish.cu",
                              "zkmember_tpu/msm/straus.py:76,204"),
            "msm_finish_fp2": ("zkmember_tpu_torch/csrc/msm_finish.cu",
                               "zkmember_tpu/msm/straus.py:76,204"),
            "select_reduce_fp48": ("zkmember_tpu_torch/csrc/select_reduce.cu",
                                   "zkmember_tpu/msm/pallas_msm.py:268"),
            "msm_finish_fp48": ("zkmember_tpu_torch/csrc/msm_finish.cu",
                                "zkmember_tpu/msm/straus.py:76,204"),
        }
        rows = []
        for name in kernels.LAUNCHES:
            src, rep = sources[name]
            msm = [m for m in MSM_TIMES if m["name"] == name]
            if msm:  # K1 and the finish: the first path's first group, the rest as shapes
                r, more = msm[0], msm[1:]
                launches = sum(m["launches"] for m in msm if m["path"] == r["path"])
            else:  # K2 at prove_lm's proof, K3 at the v1 proof's fixed-base wave
                r = RESULTS[name]
                launches = RESULTS["launches" if name in PROVE_KERNELS else "launches_v1"][name]
                more = []
            row = {
                "name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches, "max_abs_err": ERRS[name],
                "check": f"bit-exact against the plain version at {len(CHECKS[name])} "
                         "shapes, every shape of one proof of each path among them",
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": None, "shape": r["shape"],
            }
            row["path"] = r.get("path", "proof" if name in PROVE_KERNELS else "v1 proof")
            for k in ("group", "operand_b", "device_ms", "host_us", "in_l2", "tail_ms",
                      "join_ms", "waves", "wave_us"):
                if k in r:
                    row[k] = r[k]
            if name.startswith("msm_finish"):  # registers and spills of its kernels
                row["ptxas"] = [p for p in RESULTS.get("finish_ptxas", [])
                                if (p["kernel"].split()[1] == "fp2") == name.endswith("fp2")
                                and p["kernel"].endswith("n=48") == name.endswith("fp48")]
            if name == "mont_mul":  # launches of the options, batched, depth-32, BW6-761 and
                # Marlin proofs and of the on-the-fly routes; K2 at a Marlin proof's NTT
                # shapes and at the options proof's new shapes
                row["options_launches"] = RESULTS["options"]["launches"][name]
                row["batched_launches"] = RESULTS["prove_batch"]["launches"][name]
                row["scale_launches"] = RESULTS["scale"]["launches"][name]
                row["scale_onthefly_launches"] = RESULTS["scale"]["onthefly"]["launches"][name]
                row["bw6_launches"] = RESULTS["bw6"]["launches"][name]
                row["marlin_launches"] = RESULTS["marlin"]["launches"][name]
                row["marlin_budget_launches"] = RESULTS["marlin"]["budget"]["launches"][name]
                row["multi_launches"] = {k: RESULTS["multi"][k]["launches"][name]
                                         for k in ("min_lanes", "options")}
                more = (RESULTS["marlin"]["mont_mul_shapes"] + RESULTS["options"]["mont_mul_shapes"]
                        + RESULTS["marlin"]["budget"]["mont_mul_shapes"])
            elif name == "mont_mul_bm":  # the depth-32 setup; BW6-761's v1 proof at n = 48;
                # the Marlin setup's fixed-base wave
                row["scale_launches"] = RESULTS["scale"]["setup_launches"][name]
                more = [dict(RESULTS["mont_mul_bm_bw6"], path="bw6 v1 proof",
                             launches=RESULTS["bw6"]["launches_v1"][name]),
                        RESULTS["marlin"]["mont_mul_bm"]] + RESULTS["hash"]["k3"]
                row["hash_launches"] = {s: RESULTS["hash"][s]["launches"][name]
                                        for s in ("pedersen381", "pedersen761")}
                # the sharded primitives' K3 shapes, each held under checked_run
                prims = RESULTS["multi"]["primitives"]
                row["multi_shapes"] = {k: v["k3_shapes"] for k, v in prims.items()
                                       if k != "k3_timed"}
                more += prims["k3_timed"]
            row["shapes"] = [_shape_row(m) for m in more]
            proof_1024 = RESULTS["hash"]["proof"]  # the in-process 1,024-member proof
            for key in ("launches", "setup_launches", "table_launches"):
                if name in proof_1024[key]:
                    row[f"proof_1024_{key}"] = proof_1024[key][name]
            rows.append(row)
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
    else:  # a phase alone: its line (and the kernel times)
        if "options" in RESULTS:
            print(options_line())
        if "multi" in RESULTS:
            print(multi_line())
        if "bench" in RESULTS:
            print(bench_line())
        if "hash" in RESULTS:
            print(hash_line())
        if "marlin" in RESULTS:
            print(marlin_line())
        if MSM_TIMES:
            print(json.dumps({"msm_times": MSM_TIMES}))
        if TRACES:
            print(json.dumps({"trace": TRACES}))
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
