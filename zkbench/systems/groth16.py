"""Groth16 through the port's ``snark/prove_lm``: what a configuration with
``"system": "groth16"`` sets up, proves with, reads back and is checked by.

``setup`` makes the key on the device from the seed's toxic waste
(``groth16.setup``), its planes and tables (``Groth16KeysLM``) and warms
them (``warm``).  A mix's ``entry`` is ``prove`` (one proof a request) or
``prove_batch``.  The check (``zkb.check``) replays the toxic waste and
every proof's (r, s) for the plain reference (``reference/groth16_ref.py``),
with the curve's constants from ``reference/curves/<curve>.json`` and the
program's limb widths (``fq_limbs``, ``fr_limbs``) from the configuration.
"""

from __future__ import annotations

from zkb import check as chk
from zkb.traffic import stream

ENTRIES = ("prove", "prove_batch")


def setup(config: dict, key_cs, seed: int, device, log):
    """The program's proving state for circuits shaped like key_cs."""
    from zkmember_tpu_torch.snark import groth16, prove_lm

    pk, _ = groth16.setup(key_cs, config["curve"], stream(seed, "toxic_waste"), device=device)
    log(f"setup on the device, M = {pk.domain_size}")
    keys = prove_lm.Groth16KeysLM(pk, device)
    prove_lm.warm(keys)
    return keys


def program_prover(cell, keys, make_ref=None):
    """The program's entry for a request of the cell's mix:
    prove(css, rng, phase_times) -> proofs."""
    from zkmember_tpu_torch.snark import prove_lm

    entry, P = cell.traffic["entry"], cell.traffic["proofs_per_request"]
    if entry not in ENTRIES or (entry == "prove" and P != 1):
        raise ValueError(f"entry {entry!r} with {P} proofs a request ({', '.join(ENTRIES)}; "
                         f"prove takes one)")
    if entry == "prove":
        return lambda css, rng, phases: [prove_lm.prove(keys, css[0], rng=rng, phase_times=phases)]
    return lambda css, rng, phases: prove_lm.prove_batch(keys, css, rng=rng, phase_times=phases)


def reference(config: dict, key_cs, seed: int):
    """The plain reference over the key's circuit and the seed's toxic waste."""
    return chk.reference_for(key_cs, config["curve"], chk.toxic_waste(seed, config["curve"]))


def read_back(keys, config: dict, seed: int) -> dict:
    """What the check reads of the program's key, as host ints."""
    return chk.dump_key(keys.pk, seed, config["fq_limbs"])


def msm_rows(keys, config: dict) -> list:
    """(n_limbs, fp2, nbits, fr_limbs, lanes) of each MSM row of one proof:
    G1's a, b1, l and h queries and G2's b query, at their point counts."""
    from reference.groth16_ref import curve_constants

    pk = keys.pk
    nbits = curve_constants(pk.curve)["r"].bit_length()
    fq, fr = config["fq_limbs"], config["fr_limbs"]
    g2_fp2 = curve_constants(pk.curve)["g2_fp2"]
    g1 = lambda lanes: (fq, False, nbits, fr, lanes)  # noqa: E731
    return [g1(len(pk.a_nonzero)), g1(len(pk.b_nonzero)), g1(len(pk.l_nonzero)),
            g1(pk.domain_size - 1), (fq, g2_fp2, nbits, fr, len(pk.b_nonzero))]


answer = chk.proof_ints  # a proof -> the affine ints the check compares
assignment = chk.assignment  # (reference, a circuit's values) -> its witness ints, or None
numbers = chk.numbers  # (reference, config, pool, key, records, seed, attempted) -> [(name, value, limit)]
