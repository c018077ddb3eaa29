"""The comparison that decides ``correct``: the program's key and every
proof of the window against the plain reference (``reference/``).

The harness hands the reference plain ints: the toxic waste and each
proof's (r, s), replayed from the seed's streams that the program drew
them from (``rng.randrange``: setup's alpha, beta, gamma, delta, tau in
[1, r), then each proof's r and s in [0, r), a batch's first), the rows of
the key's circuit (the program's synthesis in set-up, held to the sizes the
configuration states), the pool's assignments (held to the key's rows, and
their public inputs to the root and digests that the reference's own
Pedersen CRH derives from the seed: ``reference/circuits/<circuit>.py``),
a seeded sample of the key's points read back from the device, and the
proofs' affine coordinates.  Every
number compared is a count of disagreements, with the limit 0.
"""

from __future__ import annotations

import numpy as np

from reference import groth16_ref as ref_mod
from zkb.traffic import stream

QUERIES = ("a", "b_g1", "b_g2", "h", "l")
KEY_SAMPLES = 32  # points drawn a query, besides its first and last


def coord(v):
    """A host field element of the program (or plain ints) -> ints."""
    if isinstance(v, int):
        return v
    if isinstance(v, tuple):
        return tuple(coord(x) for x in v)
    if hasattr(v, "coeffs"):
        return tuple(int(c.v) for c in v.coeffs)
    return int(v.v)


def point(p):
    return None if p is None else (coord(p[0]), coord(p[1]))


def proof_ints(proof) -> tuple:
    return point(proof.a), point(proof.b), point(proof.c)


def _rows(c, idx):
    if isinstance(c, tuple):
        return tuple(_rows(x, idx) for x in c)
    if hasattr(c, "cpu"):
        import torch

        return c[torch.as_tensor(idx, device=c.device)].cpu().numpy()
    return np.asarray(c)[idx]


def _decode(c, q: int, n: int):
    if isinstance(c, tuple):
        return list(zip(*(_decode(x, q, n) for x in c)))
    return ref_mod.from_mont_limbs(c, q, n)


def dump_key(pk, seed: int, fq_limbs: int) -> dict:
    """What the check reads of the program's key, as host ints: the index
    lists, the verifying key and a seeded sample of every query's points
    (the program's Montgomery planes of ``fq_limbs`` 16-bit limbs)."""
    fq = ref_mod.curve_constants(pk.curve)["q"]
    rng = stream(seed, "key_sample")
    queries = {}
    for q in QUERIES:
        planes = getattr(pk, q + "_query")
        L = len(planes)
        idx = sorted({0, L - 1} | set(rng.sample(range(L), min(KEY_SAMPLES, L)))) if L else []
        xs = _decode(_rows(planes.x, idx), fq, fq_limbs)
        ys = _decode(_rows(planes.y, idx), fq, fq_limbs)
        queries[q] = {"length": L, "points": list(zip(idx, zip(xs, ys)))}
    vk = pk.vk
    return {
        "curve": pk.curve, "domain_size": pk.domain_size, "num_instance": pk.num_instance,
        "a_nonzero": list(pk.a_nonzero), "b_nonzero": list(pk.b_nonzero),
        "l_nonzero": list(pk.l_nonzero), "queries": queries,
        "vk": {"alpha_g1": point(vk.alpha_g1), "beta_g1": point(pk.beta_g1),
               "delta_g1": point(pk.delta_g1), "beta_g2": point(vk.beta_g2),
               "gamma_g2": point(vk.gamma_g2), "delta_g2": point(vk.delta_g2),
               "gamma_abc_g1": [point(p) for p in vk.gamma_abc_g1]},
    }


def toxic_waste(seed: int, curve: str) -> ref_mod.Toxic:
    """What setup drew from the seed's "toxic_waste" stream."""
    rng, r = stream(seed, "toxic_waste"), ref_mod.curve_constants(curve)["r"]
    return ref_mod.Toxic(*(rng.randrange(1, r) for _ in range(5)))


def reference_for(key_cs, curve: str, toxic) -> ref_mod.Reference:
    """The reference over the circuit the key was made from."""
    return ref_mod.Reference(curve, toxic, key_cs.A, key_cs.B, key_cs.C, key_cs.num_instance,
                             key_cs.num_variables)


SHAPE = (("constraints", "nc"), ("instance", "ni"), ("variables", "nv"), ("domain_size", "M"))


def shape_wrong(ref, config: dict) -> int:
    """Sizes of the key's circuit that differ from the configuration's."""
    return sum(getattr(ref, attr) != config[key] for key, attr in SHAPE)


def assignment(ref, values) -> list | None:
    """A circuit's assignment as ints mod r; None where its length is not
    the key circuit's."""
    z = [int(v) % ref.r for v in values]
    return z if len(z) == ref.nv else None


def witness_wrong(ref, pool: list) -> int:
    """Over the pool's (assignment, public inputs): rows each assignment
    breaks under the key's circuit, and assignments of the wrong length."""
    return sum(1 if z is None else ref.unsatisfied_rows(z) for z, _ in pool)


def publics_wrong(ref, pool: list) -> int:
    """Over the pool's (assignment, public inputs the reference derived):
    the assignment's public inputs that differ from them, and each list of
    the wrong length."""
    bad = 0
    for z, pub in pool:
        bad += len(pub) != ref.ni - 1
        if z is not None:
            bad += sum(1 for x, y in zip(z[1:ref.ni], pub) if x != int(y) % ref.r)
    return bad


def key_wrong(ref, key: dict) -> int:
    bad = 0 if ref.generators_ok() else 1
    nz = ref.nonzero()
    bad += key["domain_size"] != ref.M
    bad += key["num_instance"] != ref.ni
    bad += sum(key[k + "_nonzero"] != nz[k] for k in ("a", "b", "l"))
    want = ref.vk_points()
    for name, pt in key["vk"].items():
        bad += pt != want[name]
    lengths = {"a": len(nz["a"]), "b_g1": len(nz["b"]), "b_g2": len(nz["b"]), "h": ref.M - 1,
               "l": len(nz["l"])}
    for q, d in key["queries"].items():
        bad += d["length"] != lengths[q]
        for k, pt in d["points"]:
            bad += k >= lengths[q] or pt != ref.key_point(q, k, nz)
    return bad


def proofs_wrong(ref, pool: list, records, seed: int) -> tuple[int, int]:
    """(proofs that differ from the reference's, proofs compared).  The
    window's proofs, in order, took the "proofs" stream's draws in pairs;
    a record's ``positions`` index the pool, its ``proofs`` are affine ints
    or None for a proof that failed."""
    rng = stream(seed, "proofs")
    scalars: dict = {}
    bad = checked = 0
    for rec in records:
        pairs = [(rng.randrange(ref.r), rng.randrange(ref.r)) for _ in rec["positions"]]
        for pos, proof, (rr, ss) in zip(rec["positions"], rec["proofs"], pairs):
            z = pool[pos][0]
            if proof is None or z is None:
                continue
            if pos not in scalars:
                scalars[pos] = ref.witness_scalars(z)
            bad += proof != ref.proof_points(*ref.proof_scalars(scalars[pos], rr, ss))
            checked += 1
    return bad, checked


def numbers(ref, config: dict, pool: list, key, records, seed: int, attempted: int) -> list:
    """[(name, value, limit)] of every number compared."""
    bad, checked = proofs_wrong(ref, pool, records, seed)
    return [
        ("proofs_wrong", bad, 0),
        ("proofs_unchecked", attempted - checked, 0),
        ("key_points_wrong", key_wrong(ref, key), 0),
        ("witness_rows_wrong", witness_wrong(ref, pool), 0),
        ("publics_wrong", publics_wrong(ref, pool), 0),
        ("circuit_sizes_wrong", shape_wrong(ref, config), 0),
    ]


def correct(failed: int, numbers: list) -> bool:
    """The run's verdict: every proof answered and every number within its
    limit."""
    return failed == 0 and all(v <= lim for _, v, lim in numbers)
