"""ZKMEMBER_TRACE in the port's provers, on the toy cube circuit on the CPU.

With the trace on, prove_lm.prove prints one '# {"phase": ...}' line a
phase under the port's phase names, one '# {"metric": "msm_all", ...}' line
whose u32_mults is the reference's formula at the base field's limb count
(where the G1 and G2 coordinates live), then the phase table; the v1
groth16.prove prints its phase lines and table.  The JAX prove_lm, traced
the same way, counts at the scalar field's limbs: 2.25 times too little at
BLS12-381.  Traced proofs equal untraced ones and the JAX proof under
test_rng(7); with the trace off nothing reaches stderr.
"""

import contextlib
import io
import json
import os
import re
from types import SimpleNamespace

import pytest
import torch
from test_torch_prove import cube_circuit, key_as_numpy, point_ints

from zkmember_tpu.curves import bls12_381 as jbls
from zkmember_tpu.r1cs import gadgets as jg
from zkmember_tpu.r1cs.cs import ConstraintSystem as JCS
from zkmember_tpu.snark import groth16 as jgroth16, prove_lm as jprove_lm
from zkmember_tpu.utils import rng as jrng
from zkmember_tpu_torch.curves import bls12_381 as bls
from zkmember_tpu_torch.r1cs import gadgets as g
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import obs
from zkmember_tpu_torch.utils import rng as frng

LM_PHASES = ["matrix_evals", "h_pipeline", "witness_planes", "g1_select_reduce", "g1_finish",
             "g2_select_reduce", "g2_finish", "fetch", "assemble"]
OPTIONS_PHASES = ["matrix_evals", "h_pipeline", "witness_planes", "g1_table",
                  "g1_select_reduce", "g1_finish", "g2_table", "g2_select_reduce", "g2_finish",
                  "g1_bool", "g2_bool", "fetch", "assemble"]
V1_PHASES = ["matrix_evals", "h_kernel", "h_to_host", "msm_a", "msm_b1", "msm_b2", "msm_h",
             "msm_l", "assemble"]
DUMP = re.compile(r"^  (\S+)\s+(\d+\.\d{3})s$")


def _run(fn, trace: bool):
    """fn()'s result and what it printed to stderr, with ZKMEMBER_TRACE set
    or unset around the call."""
    old = os.environ.pop("ZKMEMBER_TRACE", None)
    if trace:
        os.environ["ZKMEMBER_TRACE"] = "1"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            out = fn()
    finally:
        os.environ.pop("ZKMEMBER_TRACE", None)
        if old is not None:
            os.environ["ZKMEMBER_TRACE"] = old
    return out, buf.getvalue()


def _parse(text: str):
    """(phase lines, metric lines, dump rows) of a trace; every line is one
    of the three."""
    phases, metrics, dump = [], [], []
    for line in text.splitlines():
        if line.startswith("# "):
            rec = json.loads(line[2:])
            (phases if "phase" in rec else metrics).append(rec)
        else:
            m = DUMP.match(line)
            assert m, f"not a trace line: {line!r}"
            dump.append((m.group(1), float(m.group(2))))
    return phases, metrics, dump


def _check_dump(phases, dump):
    """The table sums each phase's seconds, largest first."""
    sums = {}
    for p in phases:
        sums[p["phase"]] = sums.get(p["phase"], 0.0) + p["s"]
    assert {name for name, _ in dump} == set(sums)
    assert [s for _, s in dump] == sorted((s for _, s in dump), reverse=True)
    for name, s in dump:
        assert s == pytest.approx(sums[name], abs=1e-3 + 1e-4 * len(phases))


@pytest.fixture(scope="module")
def toy():
    torch.set_num_threads(1)
    jcs, out_val = cube_circuit(JCS, jg, jbls.Fr, jbls.R)
    cs, _ = cube_circuit(ConstraintSystem, g, bls.Fr, bls.R)
    pk, vk = jgroth16.setup(jcs, curve="bls12_381", rng=jrng.test_rng(), host=True)
    planes, meta = key_as_numpy(pk, vk)
    keys = prove_lm.keys_from_numpy(planes, device="cpu", **meta)
    jkeys = jprove_lm.Groth16KeysLM(pk, jcs)
    traced, traced_err = _run(lambda: prove_lm.prove(keys, cs, rng=frng.test_rng(7)), True)
    plain, plain_err = _run(lambda: prove_lm.prove(keys, cs, rng=frng.test_rng(7)), False)
    v1, v1_err = _run(lambda: groth16.prove(keys.pk, cs, rng=frng.test_rng(7), device="cpu"),
                      True)
    ref, ref_err = _run(lambda: jprove_lm.prove(jkeys, jcs, rng=jrng.test_rng(7)), True)
    return SimpleNamespace(cs=cs, out_val=out_val, keys=keys, jkeys=jkeys, traced=traced,
                           traced_err=traced_err, plain=plain, plain_err=plain_err, v1=v1,
                           v1_err=v1_err, ref=ref, ref_err=ref_err)


def _u32(M, B2g, n):
    """The reference's msm_all count at n limbs (BLS12-381: 255-bit scalars,
    G2 over Fq2)."""
    return 4 * obs.straus_msm_work(M, n, 255) + obs.straus_msm_work(B2g, n, 255, fp2=True)


def test_prove_lm_trace(toy):
    phases, metrics, dump = _parse(toy.traced_err)
    assert [p["phase"] for p in phases] == LM_PHASES
    assert all(set(p) == {"phase", "s"} and p["s"] >= 0 for p in phases)
    (line,) = metrics
    assert set(line) == {"metric", "u32_mults", "seconds", "u32_mults_per_sec", "imads",
                         "imads_per_sec", "mfu_vs_imad_peak", "mfu_vs_kernel_peak"}
    assert line["metric"] == "msm_all"
    keys = toy.keys
    assert keys.fr.n == 16 and keys.cfg.fq_spec.n == 24
    assert line["u32_mults"] == _u32(keys.M, keys.B2g, 24)
    msm_s = sum(p["s"] for p in phases if p["phase"].startswith(("g1_", "g2_")))
    assert line["seconds"] == pytest.approx(msm_s, abs=5e-4)
    # the table route at 64 lanes: K1 tiles of 2 lanes per thread, 32 out
    assert (keys.B1, keys.B2g) == (64, 64)
    want = sum(obs.select_reduce_work(24, fp2, 64, 1, R, 64, 32)[1]
               + obs.finish_work(24, fp2, 64, R, 32)[1] for fp2, R in ((False, 4), (True, 1)))
    assert line["imads"] == want
    assert 0 <= line["mfu_vs_imad_peak"] <= line["mfu_vs_kernel_peak"]
    _check_dump(phases, dump)


def test_reference_trace_counts_at_scalar_limbs(toy):
    """The JAX prover's own line counts the MSMs' products at Fr's 16 limbs;
    the same lanes at Fq's 24 limbs count (24 / 16)^2 = 2.25 times as many."""
    phases, metrics, _ = _parse("\n".join(ln for ln in toy.ref_err.splitlines()
                                          if ln.startswith("# ")))
    assert "msm_dispatch" in [p["phase"] for p in phases]
    (line,) = metrics
    jk = toy.jkeys
    assert line["u32_mults"] == _u32(jk.M, jk.B2g, 16)
    assert _u32(jk.M, jk.B2g, 24) * 4 == line["u32_mults"] * 9
    assert "mfu_vs_vpu_peak" in line and "imads" not in line


def test_traced_proofs_equal_untraced_and_reference(toy):
    for proof in (toy.traced, toy.v1):
        assert (proof.a, proof.b, proof.c) == (toy.plain.a, toy.plain.b, toy.plain.c)
    for got, want in ((toy.traced.a, toy.ref.a), (toy.traced.b, toy.ref.b),
                      (toy.traced.c, toy.ref.c)):
        assert point_ints(got) == point_ints(want)
    assert groth16.verify(toy.keys.pk.vk, [toy.out_val], toy.traced)


def test_v1_trace(toy):
    phases, metrics, dump = _parse(toy.v1_err)
    assert [p["phase"] for p in phases] == V1_PHASES
    assert metrics == []  # the reference's v1 prover prints no throughput line
    _check_dump(phases, dump)


def test_untraced_prints_nothing(toy):
    assert toy.plain_err == ""


def test_options_route_trace(toy):
    """A precompute=False, merge_bool=False key: per-call tables and the
    boolean class, each a phase, counted in imads."""
    keys = prove_lm.Groth16KeysLM(toy.keys.pk, "cpu", cs=toy.cs, precompute=False,
                                  merge_bool=False)
    assert keys.has_bool
    proof, err = _run(lambda: prove_lm.prove(keys, toy.cs, rng=frng.test_rng(7)), True)
    assert (proof.a, proof.b, proof.c) == (toy.plain.a, toy.plain.b, toy.plain.c)
    phases, (line,), dump = _parse(err)
    assert [p["phase"] for p in phases] == OPTIONS_PHASES
    _check_dump(phases, dump)
    B1, B2g = keys.B1, keys.B2g
    nt1 = B1 // 2  # 64 lanes: 2 a thread
    nt2 = B2g // 2
    want = (obs.select_reduce_work(24, False, 64, 1, 4, B1, nt1)[1]
            + obs.finish_work(24, False, 64, 4, nt1)[1] + obs.table_work(24, False, 4, B1)
            + obs.select_reduce_work(24, True, 64, 1, 1, B2g, nt2)[1]
            + obs.finish_work(24, True, 64, 1, nt2)[1] + obs.table_work(24, True, 1, B2g)
            + obs.add_imads(24, False, 3 * (keys.Bb - 1)) + obs.add_imads(24, True, keys.B2b - 1))
    assert line["imads"] == want
    assert line["u32_mults"] == _u32(keys.M, B2g, 24)


def test_only_rank_zero_traces(toy, monkeypatch):
    """With a mesh, rank 0 prints the phase lines and msm_all (imads of its
    lane block); other ranks print nothing."""
    seen = []

    def fake_prove(keys, cs_list, rng, phase_times, mesh=None, prof=None):
        seen.append(prof)
        if prof is not None:
            prof.record("g1_select_reduce", 0.5)
        return [toy.plain]

    monkeypatch.setattr(prove_lm, "_prove", fake_prove)
    for rank, printed in ((1, False), (0, True)):
        mesh = SimpleNamespace(rank=rank, shape={"dp": 1, "msm": 2})
        _, err = _run(lambda: prove_lm.prove(toy.keys, toy.cs, mesh=mesh), True)
        assert (seen[-1] is not None) == printed
        assert bool(err) == printed
    phases, (line,), _ = _parse(err)
    assert [p["phase"] for p in phases] == ["g1_select_reduce"] and line["seconds"] == 0.5
    # rank 0's block of 32 lanes is padded to K1's 64; the finish runs over both ranks' lanes
    want = sum(obs.select_reduce_work(24, fp2, 64, 1, R, 64, 32)[1]
               + obs.finish_work(24, fp2, 64, R, 64)[1] for fp2, R in ((False, 4), (True, 1)))
    assert line["imads"] == want
