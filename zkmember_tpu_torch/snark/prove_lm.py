"""Groth16 prover on limb-major planes (counterpart of zkmember_tpu.snark.prove_lm).

Pipeline for a batch of P proofs over one key (``prove`` is a batch of one):

  host    witness -> native CSR matvecs (A z, B z, C z), per proof
  device  H = coset-NTT pipeline over all P proofs (ntt.lm.groth16_h_batch;
          products on kernel K2)
  device  the four G1 MSMs (a, b1, l, h) of every proof as ONE stacked
          Straus MSM of P x 4 rows, and the P G2 MSMs (b2), both from the
          shared precomputed tables through kernel K1 (proof-batch axis)
          plus the narrow tail reduction and the Horner join
  device  one packed device -> host copy of every accumulator
  host    randomized assembly (A, B, C from r, s), per proof

By default the boolean witness lanes are merged into the general Straus
lanes (0/1 scalars select table entries 0/1) and the key keeps both
tables.  A key's options (``Groth16KeysLM``) give ``prove`` two more
routes, one proof at a time: past the table budget, or with
``precompute=False``, each MSM builds its table on the fly
(``straus.msm_program_chunked``); with ``merge_bool=False`` the boolean
class runs as two masked lane reductions (``straus.bool_msm_program``)
whose points the host adds to the general ones.  Zero-padded lanes select
entry 0, the identity, and vanish.

With a mesh (``parallel.dist``; ``prove(..., mesh=)``), every MSM splits its
lanes over the mesh axis "msm" (``straus.sharded_msm_program``: each rank's
block of the kept table, or of a table built on the fly where the key
keeps none; the boolean class through ``straus.sharded_bool_msm_program``),
while the H pipeline stays on each rank and every rank assembles the same
proof.  Such a key is built with ``min_lanes`` = the axis size.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import lm
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import select_reduce_cuda, straus
from zkmember_tpu_torch.ntt import lm as nttlm
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.snark import groth16
from zkmember_tpu_torch.utils import obs
from zkmember_tpu_torch.utils import rng as frng

# The kernel tiles lanes in multiples of 64; narrower keys pad up to it.
MIN_LANES = 64


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def sw_ops(cfg: "groth16.PairingConfig", g2: bool, device) -> cdv.SWOps:
    """Limb-major SWOps for a pairing config's G1 or G2, b3 = 3 b (G2 over
    Fq2 for BLS12-381, over the base field for BW6-761)."""
    if g2:
        F_ops = lm.Fp2OpsLM if cfg.g2_fp2 else lm.FpOpsLM
        F, curve = F_ops(cfg.g2_spec, device), cfg.mod.G2
    else:
        F, curve = lm.FpOpsLM(cfg.fq_spec, device), cfg.mod.G1
    return cdv.SWOps(F, cdv.b3_of(curve), f"{cfg.name}_{'g2' if g2 else 'g1'}/lm")


def _pad_lanes(arr: np.ndarray, B: int) -> np.ndarray:
    b = arr.shape[-1]
    if b > B:
        raise ValueError(f"{b} lanes do not fit the key's {B} lanes")
    if b == B:
        return arr
    return np.pad(arr, [(0, 0)] * (arr.ndim - 1) + [(0, B - b)])


def _dev_planes(c, B, device):
    """(k, n) batch-major coordinate planes (host numpy or a tensor) ->
    (n, B) int32 on device."""
    if isinstance(c, tuple):
        return tuple(_dev_planes(ci, B, device) for ci in c)
    if isinstance(c, torch.Tensor):  # setup leaves the planes on its device
        c = c.cpu().numpy()
    arr = _pad_lanes(np.swapaxes(np.asarray(c), -1, -2), B)
    return torch.as_tensor(arr.astype(np.int64), dtype=torch.int32, device=device)


class Groth16KeysLM:
    """Limb-major proving-key planes on the device, the static scalar
    classes, and the Straus tables where they are kept.

    Lanes: the G1 general rows [a, b1, l, h] share B1 = max(M, MIN_LANES)
    lanes; the G2 general b-query takes B2g lanes, the next power of two
    of its point count (at least MIN_LANES: K1 reads both).  With
    ``merge_bool=False`` the boolean witness class (``cs.boolean_vars``)
    leaves the general rows for its own planes: G1 rows [a, b1, l] of Bb
    lanes and the G2 b-query of B2b lanes, summed by masked lane
    reductions (``straus.bool_msm_program``) with no table and no K1."""

    def __init__(self, pk: "groth16.ProvingKey", device=None, *, cs: ConstraintSystem | None = None,
                 min_lanes: int = 1, precompute: bool = True, merge_bool: bool = True):
        """min_lanes: pad every lane count to at least this (the device count
        of a sharded prover, so every plane divides evenly).
        precompute: keep the Straus tables, G1's and then G2's, each while
        the kept tables fit the device's ``straus.table_budget``; otherwise
        every proof builds the table of each MSM's lanes on the fly and
        drops it (``straus.msm_program_chunked``).
        merge_bool: keep the boolean witness class in the general lanes
        (0/1 scalars select table entries 0/1); False splits it out and
        needs the circuit `cs` for its boolean variables."""
        if not merge_bool and cs is None:
            raise ValueError("merge_bool=False needs the circuit (cs=...) for its boolean variables")
        self.device = devmod.resolve(device)
        self.pk = pk
        cfg = groth16.pairing_config(pk.curve)
        self.cfg = cfg
        self.ops1 = sw_ops(cfg, False, self.device)
        self.ops2 = sw_ops(cfg, True, self.device)
        self.fr = cfg.fr_spec
        self.nwin = (cfg.r.bit_length() + straus.WINDOW_BITS - 1) // straus.WINDOW_BITS
        M = pk.domain_size
        self.M = M
        ni = pk.num_instance

        counts = {
            "a": len(pk.a_nonzero), "b": len(pk.b_nonzero),
            "l": len(pk.l_nonzero), "h": len(pk.h_query),
        }
        over = {k: v for k, v in counts.items() if v > M}
        if over:
            raise ValueError(
                f"merged lane counts {over} exceed the domain size M = {M}: the "
                "G1 rows hold at most M lanes"
            )
        self.domain_lm = nttlm.DomainLM.get(self.fr, M, self.device)
        B1 = max(M, MIN_LANES, min_lanes)
        self.B1 = B1
        dev = self.device

        boolean = frozenset() if merge_bool else frozenset(cs.boolean_vars)

        def split(nz, to_abs=lambda i: i):
            """A query's nonzero columns -> (general, boolean) absolute
            columns and their positions in the query, in the key's order."""
            gen = [k for k, i in enumerate(nz) if to_abs(i) not in boolean]
            boo = [k for k, i in enumerate(nz) if to_abs(i) in boolean]
            cols = np.asarray([to_abs(i) for i in nz], np.int64)
            return cols[gen], cols[boo], np.asarray(gen, np.int64), np.asarray(boo, np.int64)

        a_gen, a_boo, a_gt, a_bt = split(pk.a_nonzero)
        b_gen, b_boo, b_gt, b_bt = split(pk.b_nonzero)
        l_gen, l_boo, l_gt, l_bt = split(pk.l_nonzero, to_abs=lambda i: i + ni)

        def rows(attr, take, B):
            pa = getattr(pk, attr)
            return (_dev_planes(_take(pa.x, take), B, dev),
                    _dev_planes(_take(pa.y, take), B, dev))

        # G1 general planes: rows [a, b1, l, h], B1 lanes
        planes = [rows("a_query", a_gt, B1), rows("b_g1_query", b_gt, B1),
                  rows("l_query", l_gt, B1), rows("h_query", None, B1)]
        self.g1_X = torch.stack([p[0] for p in planes])  # (4, n, B1)
        self.g1_Y = torch.stack([p[1] for p in planes])
        # absolute z columns of the a, b1, l rows (the h row takes H's limbs)
        self.gen_cols = [a_gen, b_gen, l_gen]

        # G1 boolean planes: rows [a, b1, l], Bb lanes
        Bb = max(min_lanes, _next_pow2(max(len(a_bt), len(b_bt), len(l_bt), 1)))
        self.Bb = Bb
        self.bool_cols = [a_boo, b_boo, l_boo]
        self.has_bool = any(len(c) for c in self.bool_cols)
        if self.has_bool:
            planes = [rows("a_query", a_bt, Bb), rows("b_g1_query", b_bt, Bb),
                      rows("l_query", l_bt, Bb)]
            self.g1b_X = torch.stack([p[0] for p in planes])  # (3, n, Bb)
            self.g1b_Y = torch.stack([p[1] for p in planes])

        # G2 (b-query): general B2g lanes (K1 reads them), boolean B2b lanes
        B2g = max(min_lanes, MIN_LANES, _next_pow2(max(len(b_gt), 1)))
        B2b = max(min_lanes, _next_pow2(max(len(b_bt), 1)))
        self.B2g, self.B2b = B2g, B2b
        self.g2_X, self.g2_Y = rows("b_g2_query", b_gt, B2g)
        if self.has_bool:
            self.g2b_X, self.g2b_Y = rows("b_g2_query", b_bt, B2b)
        self.b_cols, self.b_bool_cols = b_gen, b_boo

        # The tables are 48 times the point planes (16 entries x 3 projective
        # coordinates): kept only within the device's table budget.
        budget = straus.table_budget(dev)
        g1_bytes = straus.table_bytes(self.ops1, 4, B1)
        self._want_g1_tab = precompute and g1_bytes <= budget
        if self._want_g1_tab:
            budget -= g1_bytes
        self._want_g2_tab = precompute and straus.table_bytes(self.ops2, 1, B2g) <= budget
        self._g1_tab = None
        self._g2_tab = None

    def build_tables(self):
        """Build the wanted Straus tables [0..15] P of the key's general
        point sets (once)."""
        if self._want_g1_tab and self._g1_tab is None:
            self._g1_tab = straus.table_program(self.ops1, self.g1_X, self.g1_Y)
        if self._want_g2_tab and self._g2_tab is None:
            self._g2_tab = straus.table_program(self.ops2, self.g2_X, self.g2_Y)

    @property
    def g1_tab(self):
        """The G1 table, built on first use; None when the key keeps none."""
        self.build_tables()
        return self._g1_tab

    @property
    def g2_tab(self):
        """The G2 table, built on first use; None when the key keeps none."""
        self.build_tables()
        return self._g2_tab


def _take(c, idx):
    """Rows idx (all rows for None) of a (k, n) coordinate (Fp2 pairs aware)."""
    if idx is None:
        return c
    if isinstance(c, tuple):
        return tuple(_take(ci, idx) for ci in c)
    if isinstance(c, torch.Tensor):
        return c[torch.as_tensor(idx, device=c.device)]
    return np.asarray(c)[idx]


def _g1_point(cfg, xy):
    F = cfg.mod.Fq
    return (F(int(xy[0])), F(int(xy[1])))


def _g2_point(cfg, xy):
    if not cfg.g2_fp2:
        return _g1_point(cfg, xy)
    (x0, x1), (y0, y1) = xy
    return (cfg.mod.fq2(int(x0), int(x1)), cfg.mod.fq2(int(y0), int(y1)))


def keys_from_numpy(planes, *, curve: str, a_nonzero, b_nonzero, l_nonzero,
                    domain_size: int, num_instance: int, vk: dict, beta_g1,
                    delta_g1, device=None) -> Groth16KeysLM:
    """Proving key from plain numpy arrays and ints -> Groth16KeysLM.

    planes: the checkpoint's (k, n) uint32 Montgomery query planes under its
    names: '<q>_x' / '<q>_y' for q in a_query, b_g1_query, h_query,
    l_query, and '<q>_x_c0', '<q>_x_c1', '<q>_y_c0', '<q>_y_c1' for
    b_g2_query over Fq2 (BLS12-381; BW6-761's G2 has '<q>_x' / '<q>_y').
    vk: alpha_g1 (x, y), beta_g2 / gamma_g2 / delta_g2 ((x0, x1), (y0, y1)),
    or (x, y) over Fq, and gamma_abc_g1 [(x, y), ...] as ints; beta_g1 and
    delta_g1 as (x, y) ints."""
    cfg = groth16.pairing_config(curve)

    def pp(name, fp2=False):
        def get(c):
            if fp2:
                return tuple(np.asarray(planes[f"{name}_{c}_c{i}"], np.uint32) for i in range(2))
            return np.asarray(planes[f"{name}_{c}"], np.uint32)

        return groth16.PointPlanes(get("x"), get("y"))

    vkey = groth16.VerifyingKey(
        curve=curve,
        alpha_g1=_g1_point(cfg, vk["alpha_g1"]),
        beta_g2=_g2_point(cfg, vk["beta_g2"]),
        gamma_g2=_g2_point(cfg, vk["gamma_g2"]),
        delta_g2=_g2_point(cfg, vk["delta_g2"]),
        gamma_abc_g1=[_g1_point(cfg, p) for p in vk["gamma_abc_g1"]],
    )
    pk = groth16.ProvingKey(
        curve=curve,
        vk=vkey,
        beta_g1=_g1_point(cfg, beta_g1),
        delta_g1=_g1_point(cfg, delta_g1),
        a_query=pp("a_query"),
        b_g1_query=pp("b_g1_query"),
        b_g2_query=pp("b_g2_query", fp2=cfg.g2_fp2),
        h_query=pp("h_query"),
        l_query=pp("l_query"),
        a_nonzero=[int(i) for i in a_nonzero],
        b_nonzero=[int(i) for i in b_nonzero],
        l_nonzero=[int(i) for i in l_nonzero],
        domain_size=int(domain_size),
        num_instance=int(num_instance),
    )
    return Groth16KeysLM(pk, device)


def _z_rows16(cs: ConstraintSystem, fr: fs.FieldSpec) -> np.ndarray:
    """Witness vector as (n_limbs16, n_vars) canonical u32 planes."""
    from zkmember_tpu_torch import native as zknative

    nl64 = (fr.n + 3) // 4
    rows = zknative.ints_to_u64(cs.values, nl64)  # (V, nl64) LE u64
    u16 = rows.view("<u2").astype(np.uint32)[:, : fr.n]  # (V, n)
    return np.ascontiguousarray(u16.T)


def _to_dev(arr: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr).astype(np.int64), dtype=torch.int32, device=device)


def _warm_step(verbose: bool, tag: str, name: str, dev, fn) -> None:
    """Run one warm-up step; with `verbose`, log its seconds to stderr in the
    reference's format (``# [<tag>] <name> ready in <s>s``), the card
    synchronized before the clock is read."""
    t0 = time.time()
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if verbose:
        print(f"# [{tag}] {name} ready in {time.time() - t0:.1f}s", file=sys.stderr, flush=True)


def warm(keys: Groth16KeysLM, verbose: bool = False):
    """Build the CUDA kernels (on a card; nothing to build for the CPU's
    plain versions) and the Straus tables the key keeps; returns when both
    are resident.  verbose: one ``# [warm] ... ready in ...s`` line a step
    on stderr, as the reference's ``warm`` logs."""
    dev = keys.device
    _warm_step(verbose, "warm", "kernels", dev,
               kernels.library if dev.type == "cuda" else (lambda: None))
    _warm_step(verbose, "warm", "tables", dev, keys.build_tables)


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for xi in x for leaf in _leaves(xi)]
    return [x]


def _unflatten(x, it):
    if isinstance(x, tuple):
        return tuple(_unflatten(xi, it) for xi in x)
    return next(it)


def warm_sharded(keys: Groth16KeysLM, mesh, verbose: bool = False):
    """The sharded counterpart of ``warm``: build the CUDA kernels (on a
    card) and run each sharded MSM class of the key once on zero scalars
    (G1's rows, G2's, and the boolean ones of a ``merge_bool=False`` key),
    so the first proof over `mesh` pays no first-call costs.  Eager
    PyTorch compiles nothing, so nothing runs in threads.  verbose: one
    ``# [warm-sh] <class> ready in ...s`` line an MSM class on stderr, the
    reference's names (g1x4, g2, g1bool, g2bool)."""
    _check_mesh_lanes(keys, mesh)
    dev = keys.device
    if dev.type == "cuda":
        kernels.library()
    nl = keys.fr.n

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    jobs = [
        ("g1x4", lambda: straus.sharded_msm_program(
            keys.ops1, mesh, keys.g1_X, keys.g1_Y, zeros(4, nl, keys.B1), keys.nwin,
            keys.g1_tab)),
        ("g2", lambda: straus.sharded_msm_program(
            keys.ops2, mesh, keys.g2_X, keys.g2_Y, zeros(nl, keys.B2g), keys.nwin,
            keys.g2_tab)),
    ]
    if keys.has_bool:
        jobs += [
            ("g1bool", lambda: straus.sharded_bool_msm_program(
                keys.ops1, mesh, keys.g1b_X, keys.g1b_Y, zeros(3, keys.Bb))),
            ("g2bool", lambda: straus.sharded_bool_msm_program(
                keys.ops2, mesh, keys.g2b_X, keys.g2b_Y, zeros(keys.B2b))),
        ]
    for name, fn in jobs:
        _warm_step(verbose, "warm-sh", name, dev, fn)


def _check_mesh_lanes(keys: Groth16KeysLM, mesh) -> None:
    """Every lane count of the key must split over the mesh axis "msm" (a
    key built with min_lanes = its size)."""
    D = mesh.shape["msm"]
    lanes = {"B1": keys.B1, "B2g": keys.B2g}
    if keys.has_bool:
        lanes.update(Bb=keys.Bb, B2b=keys.B2b)
    bad = {k: v for k, v in lanes.items() if v % D}
    if bad:
        raise ValueError(f"lane counts {bad} do not split over {D} ranks: build the key "
                         f"with min_lanes={D}")


def prove(keys: Groth16KeysLM, cs: ConstraintSystem, rng=None,
          phase_times: dict | None = None, mesh=None) -> "groth16.Proof":
    """Groth16 prove on the limb-major stack, over any key: the kept tables
    where the key has them, else the on-the-fly route, plus the boolean
    MSMs of a ``merge_bool=False`` key.  On a key with tables and merged
    boolean lanes it is ``prove_batch`` of one proof.  rng defaults to OS
    entropy for the proof randomizers r, s; tests pass
    utils.rng.test_rng().  phase_times: a dict to receive host seconds per
    phase (synchronizing the card between phases); None (the default) adds
    no synchronization.  mesh: a ``parallel.dist.Mesh``: every MSM splits
    its lanes over the mesh's "msm" axis, each rank over its block of the
    key's table where the key keeps one; every rank calls prove with the
    same rng state and gets the same proof.  The key's lane counts must
    divide by the axis size (``min_lanes``).

    ZKMEMBER_TRACE (read at each call) set: every phase's line goes to
    stderr as '# {"phase": name, "s": seconds}' (the card synchronized at
    each phase), then one '# {"metric": "msm_all", ...}' line over the
    g1_* and g2_* phases (``obs.throughput_line``) and the phase table;
    with a mesh only rank 0 prints."""
    prof = obs.trace_profiler() if mesh is None or mesh.rank == 0 else None
    proof = _prove(keys, [cs], rng, phase_times, mesh, prof)[0]
    if prof is not None:
        prof.emit(_msm_throughput(keys, prof.summary(), mesh))
        prof.dump()
    return proof


def prove_batch(keys: Groth16KeysLM, cs_list, rng=None,
                phase_times: dict | None = None) -> list["groth16.Proof"]:
    """P independent proofs over ONE proving key (the reference's proof-batch
    axis): one H pipeline over (P, 3, n, M), one G1 and one G2 MSM over the
    shared Straus tables, one device -> host copy; witness and assembly run
    per proof on the host.  Every proof's (r, s) is drawn first, in order,
    so P calls of ``prove`` with the same rng give the same proofs.  Needs
    a key that keeps both tables and merges the boolean lanes (use
    ``prove`` otherwise).  rng and phase_times as in ``prove`` (the phases
    hold all P proofs)."""
    if not (keys._want_g1_tab and keys._want_g2_tab):
        raise ValueError("prove_batch needs a key that keeps its Straus tables "
                         "(precompute=True, within the table budget)")
    if keys.has_bool:
        raise ValueError("prove_batch needs merged boolean lanes (merge_bool=True)")
    return _prove(keys, cs_list, rng, phase_times)


def _prove(keys: Groth16KeysLM, cs_list, rng, phase_times, mesh=None,
           prof: obs.Profiler | None = None) -> list["groth16.Proof"]:
    from zkmember_tpu_torch import native as zknative

    if not cs_list:
        raise ValueError("prove_batch needs at least one constraint system")
    if mesh is not None:
        _check_mesh_lanes(keys, mesh)
    pk = keys.pk
    cfg = keys.cfg
    rng = rng or frng.secure_rng()
    randomizers = [(frng.field_element(rng, cfg.r), frng.field_element(rng, cfg.r))
                   for _ in cs_list]
    fr = keys.fr
    M = keys.M
    dev = keys.device
    mark = obs.PhaseClock(phase_times, dev, prof)
    nf = zknative.NativeField.get(fr.p, fr.n)

    dabc = []
    for cs in cs_list:
        if nf is not None:
            da, db, dc, _ = groth16._matrix_evals_native(cs, M, nf)
        else:
            da, db, dc = (fr.to_mont_host(v) for v in groth16._matrix_evals(cs, M))
        dabc.append(np.stack([fs.to_lm(x) for x in (da, db, dc)]))
    dabc = _to_dev(np.stack(dabc), dev)  # (P, 3, n, M)
    mark("matrix_evals")
    h_limbs = nttlm.groth16_h_batch(keys.domain_lm, dabc)  # (P, n, M) canonical
    mark("h_pipeline")

    zq, z2, masks = [], [], []
    for cs in cs_list:
        z16 = _z_rows16(cs, fr)
        zq.append(np.stack([_pad_lanes(z16[:, cols], keys.B1) for cols in keys.gen_cols]))
        z2.append(_pad_lanes(z16[:, keys.b_cols], keys.B2g))
        if keys.has_bool:  # a boolean scalar's value is its limb 0
            masks.append((np.stack([_pad_lanes(z16[0, cols], keys.Bb) for cols in keys.bool_cols]),
                          _pad_lanes(z16[0, keys.b_bool_cols], keys.B2b)))
    h_pad = torch.nn.functional.pad(h_limbs, (0, keys.B1 - M))
    z4 = torch.cat([_to_dev(np.stack(zq), dev), h_pad[:, None]], 1)  # (P, 4, n, B1)
    z2 = _to_dev(np.stack(z2), dev)  # (P, n, B2g)
    mark("witness_planes")

    if mesh is None:
        bool_msm = straus.bool_msm_program
    else:
        def bool_msm(ops, X, Y, mask):
            return straus.sharded_bool_msm_program(ops, mesh, X, Y, mask)
    out4 = _msm(keys.ops1, keys.g1_tab, keys.g1_X, keys.g1_Y, z4, keys.nwin, mark, "g1_",
                mesh=mesh)
    out2 = _msm(keys.ops2, keys.g2_tab, keys.g2_X, keys.g2_Y, z2, keys.nwin, mark, "g2_",
                max_lanes=1 << 17, mesh=mesh)  # Fp2 coordinates double a slice's table
    outs = (out4, out2)
    if keys.has_bool:  # one proof: prove_batch refuses boolean classes
        g1m, g2m = (_to_dev(m, dev) for m in masks[0])
        outs += (_lead(bool_msm(keys.ops1, keys.g1b_X, keys.g1b_Y, g1m)),)
        mark("g1_bool")
        outs += (_lead(bool_msm(keys.ops2, keys.g2b_X, keys.g2b_Y, g2m)),)
        mark("g2_bool")

    # ONE device -> host copy for every accumulator of every proof
    leaves = _leaves(outs)
    host = torch.cat([leaf.reshape(-1) for leaf in leaves]).cpu().numpy()
    parts, off = [], 0
    for leaf in leaves:
        parts.append(host[off : off + leaf.numel()].reshape(tuple(leaf.shape)))
        off += leaf.numel()
    outs_h = _unflatten(outs, iter(parts))  # (P, 4, n, 1), (P, n, 1)[, (1, 3, n, 1), (1, n, 1)]
    mark("fetch")

    proofs = []
    g1, g2 = cfg.mod.G1, cfg.mod.G2
    for p, (rr, ss) in enumerate(randomizers):
        g1_accs = [straus.projective_to_host(g1, tuple(c[p, i] for c in outs_h[0]))
                   for i in range(4)]
        b2_acc = straus.projective_to_host(g2, tuple(straus._row(c, p) for c in outs_h[1]))
        if keys.has_bool:  # the boolean parts of a, b1, l and b2
            for i in range(3):
                g1_accs[i] = g1.add(g1_accs[i], straus.projective_to_host(
                    g1, tuple(c[p, i] for c in outs_h[2])))
            b2_acc = g2.add(b2_acc, straus.projective_to_host(
                g2, tuple(straus._row(c, p) for c in outs_h[3])))
        proofs.append(_assemble(cfg, pk, rr, ss, g1_accs, b2_acc))
    mark("assemble")
    return proofs


def _lead(P):
    """Projective coords with a leading proof axis of one."""
    return tuple(straus._map_coord(lambda c: c[None], x) for x in P)


def _msm(ops, tab, X, Y, z, nwin: int, mark, prefix: str, max_lanes: int = 1 << 18,
         mesh=None):
    """One MSM family of a proof batch: from the key's table `tab` where it
    keeps one (all P proofs in one K1 launch), else on the fly in lane
    slices of `max_lanes` (``straus.msm_program_chunked``, one proof), or
    with a mesh split over its "msm" axis (``straus.sharded_msm_program``
    over the rank's block of `tab` or of its points, one proof).  z: (P,
    [R,] nl, B); returns projective coords (P, [R,] n, 1)."""
    if mesh is not None:
        return _lead(straus.sharded_msm_program(ops, mesh, X, Y, z[0], nwin, tab, mark, prefix))
    if tab is not None:
        return straus.msm_precomp_batch(ops, tab, nwin, z, mark, prefix)
    return _lead(straus.msm_program_chunked(ops, X, Y, z[0], nwin, max_lanes, mark, prefix))


def _family_imads(ops, R: int, B: int, nwin: int, kept: bool, max_lanes: int, D: int) -> int:
    """IMADs one rank's card runs for one MSM family of ``_msm`` over R rows
    of B lanes: the per-call tables where the key keeps none, K1, the
    finish, and the on-the-fly route's slice additions; with D > 1 ranks K1
    and the tables over this rank's block, the finish over the gathered
    lanes (``straus.sharded_msm_program``)."""
    fp2, spec, _ = select_reduce_cuda.kernel_consts(ops)
    n = spec.n
    if D > 1:  # a block narrower than K1's tiles is padded after its table
        slices, blk = 1, B // D
        b = max(blk, straus.SHARD_MIN_LANES)
    else:
        slices, blk = max(1, B // max_lanes), min(B, max_lanes)
        b = blk
    nt = b // select_reduce_cuda.tile_shape(b)[1]
    one = (obs.select_reduce_work(n, fp2, nwin, 1, R, b, nt)[1]
           + obs.finish_work(n, fp2, nwin, R, nt * D)[1]
           + (0 if kept else obs.table_work(n, fp2, R, blk)))
    return slices * one + obs.add_imads(n, fp2, (slices - 1) * R)


def _bool_imads(ops, R: int, B: int, D: int) -> int:
    """IMADs of a boolean MSM over R rows of B lanes on one rank: the masked
    lane reduction of its block, then, with D > 1, over the D gathered lanes."""
    fp2, spec, _ = select_reduce_cuda.kernel_consts(ops)
    return obs.add_imads(spec.n, fp2, R * (B // D - 1 + D - 1))


def _msm_throughput(keys: Groth16KeysLM, phases: dict, mesh=None) -> str:
    """The trace's msm_all line for one proof over the seconds of its g1_*
    and g2_* phases.  u32_mults is the reference's count
    (``obs.straus_msm_work`` for the four G1 rows of M lanes and the G2 row)
    at the base field's limb count, where the G1 and G2 coordinates live;
    imads counts what this rank's card ran on the route the proof took."""
    cfg = keys.cfg
    nq, nbits = cfg.fq_spec.n, cfg.r.bit_length()
    u32 = (4 * obs.straus_msm_work(keys.M, nq, nbits)
           + obs.straus_msm_work(keys.B2g, nq, nbits, fp2=keys.pk.curve == "bls12_381"))
    D = 1 if mesh is None else mesh.shape["msm"]
    imads = (_family_imads(keys.ops1, 4, keys.B1, keys.nwin, keys._want_g1_tab, 1 << 18, D)
             + _family_imads(keys.ops2, 1, keys.B2g, keys.nwin, keys._want_g2_tab, 1 << 17, D))
    if keys.has_bool:
        imads += _bool_imads(keys.ops1, 3, keys.Bb, D) + _bool_imads(keys.ops2, 1, keys.B2b, D)
    seconds = sum(s for name, s in phases.items() if name.startswith(("g1_", "g2_")))
    return obs.throughput_line("msm_all", u32, seconds, imads)


def _assemble(cfg, pk, rr, ss, g1_accs, b2_acc) -> "groth16.Proof":
    """Host assembly of one proof from its MSMs: A, B and C with r and s."""
    g1, g2, r_mod = cfg.mod.G1, cfg.mod.G2, cfg.r
    a_acc, b1_acc, l_acc, h_acc = g1_accs
    A = g1.add(g1.add(pk.vk.alpha_g1, a_acc), g1.mul(rr, pk.delta_g1))
    B2 = g2.add(g2.add(pk.vk.beta_g2, b2_acc), g2.mul(ss, pk.vk.delta_g2))
    B1 = g1.add(g1.add(pk.beta_g1, b1_acc), g1.mul(ss, pk.delta_g1))
    C = g1.add(l_acc, h_acc)
    C = g1.add(C, g1.mul(ss, A))
    C = g1.add(C, g1.mul(rr, B1))
    C = g1.add(C, g1.mul((-rr * ss) % r_mod, pk.delta_g1))
    return groth16.Proof(curve=pk.curve, a=A, b=B2, c=C)
