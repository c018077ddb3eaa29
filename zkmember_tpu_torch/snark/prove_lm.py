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

Boolean witness lanes are merged into the general Straus lanes (0/1
scalars select table entries 0/1).  Zero-padded lanes select entry 0, the
identity, and vanish.
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch import kernels
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import lm
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import straus
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
    """Limb-major proving-key planes on the device, plus the Straus tables.

    Lanes: the G1 rows [a, b1, l, h] share max(M, MIN_LANES) lanes; the G2
    b-query takes the next power of two of its point count."""

    def __init__(self, pk: "groth16.ProvingKey", device=None):
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
        B1 = max(M, MIN_LANES)
        self.B1 = B1
        dev = self.device

        def rows(attr):
            pa = getattr(pk, attr)
            return _dev_planes(pa.x, B1, dev), _dev_planes(pa.y, B1, dev)

        planes = [rows(a) for a in ("a_query", "b_g1_query", "l_query", "h_query")]
        self.g1_X = torch.stack([p[0] for p in planes])  # (4, n, B1)
        self.g1_Y = torch.stack([p[1] for p in planes])
        # absolute z columns of the a, b1, l rows (the h row takes H's limbs)
        self.gen_cols = [
            np.asarray(pk.a_nonzero, np.int64),
            np.asarray(pk.b_nonzero, np.int64),
            np.asarray(pk.l_nonzero, np.int64) + ni,
        ]

        B2 = max(MIN_LANES, _next_pow2(max(len(pk.b_nonzero), 1)))
        self.B2 = B2
        self.g2_X = _dev_planes(pk.b_g2_query.x, B2, dev)
        self.g2_Y = _dev_planes(pk.b_g2_query.y, B2, dev)
        self.b_cols = np.asarray(pk.b_nonzero, np.int64)
        self._g1_tab = None
        self._g2_tab = None

    def build_tables(self):
        """Build the Straus tables [0..15] P of both key point sets (once)."""
        if self._g1_tab is None:
            self._g1_tab = straus.table_program(self.ops1, self.g1_X, self.g1_Y)
        if self._g2_tab is None:
            self._g2_tab = straus.table_program(self.ops2, self.g2_X, self.g2_Y)

    @property
    def g1_tab(self):
        self.build_tables()
        return self._g1_tab

    @property
    def g2_tab(self):
        self.build_tables()
        return self._g2_tab


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


def warm(keys: Groth16KeysLM):
    """Build the CUDA kernels (on a card) and the Straus tables; returns when
    both are resident."""
    if keys.device.type == "cuda":
        kernels.library()
    keys.build_tables()
    if keys.device.type == "cuda":
        torch.cuda.synchronize(keys.device)


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for xi in x for leaf in _leaves(xi)]
    return [x]


def _unflatten(x, it):
    if isinstance(x, tuple):
        return tuple(_unflatten(xi, it) for xi in x)
    return next(it)


def prove(keys: Groth16KeysLM, cs: ConstraintSystem, rng=None,
          phase_times: dict | None = None) -> "groth16.Proof":
    """Groth16 prove on the limb-major stack: ``prove_batch`` of one proof.
    rng defaults to OS entropy for the proof randomizers r, s; tests pass
    utils.rng.test_rng().  phase_times: a dict to receive host seconds per
    phase (synchronizing the card between phases); None (the default) adds
    no synchronization."""
    return prove_batch(keys, [cs], rng, phase_times)[0]


def prove_batch(keys: Groth16KeysLM, cs_list, rng=None,
                phase_times: dict | None = None) -> list["groth16.Proof"]:
    """P independent proofs over ONE proving key (the reference's proof-batch
    axis): one H pipeline over (P, 3, n, M), one G1 and one G2 MSM over the
    shared Straus tables, one device -> host copy; witness and assembly run
    per proof on the host.  Every proof's (r, s) is drawn first, in order,
    so P calls of ``prove`` with the same rng give the same proofs.
    rng and phase_times as in ``prove`` (the phases hold all P proofs)."""
    from zkmember_tpu_torch import native as zknative

    if not cs_list:
        raise ValueError("prove_batch needs at least one constraint system")
    pk = keys.pk
    cfg = keys.cfg
    rng = rng or frng.secure_rng()
    randomizers = [(frng.field_element(rng, cfg.r), frng.field_element(rng, cfg.r))
                   for _ in cs_list]
    fr = keys.fr
    M = keys.M
    dev = keys.device
    mark = obs.PhaseClock(phase_times, dev)
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

    zq, z2 = [], []
    for cs in cs_list:
        z16 = _z_rows16(cs, fr)
        zq.append(np.stack([_pad_lanes(z16[:, cols], keys.B1) for cols in keys.gen_cols]))
        z2.append(_pad_lanes(z16[:, keys.b_cols], keys.B2))
    h_pad = torch.nn.functional.pad(h_limbs, (0, keys.B1 - M))
    z4 = torch.cat([_to_dev(np.stack(zq), dev), h_pad[:, None]], 1)  # (P, 4, n, B1)
    z2 = _to_dev(np.stack(z2), dev)  # (P, n, B2)
    mark("witness_planes")

    out4 = straus.msm_precomp_batch(keys.ops1, keys.g1_tab, keys.nwin, z4, mark, "g1_")
    out2 = straus.msm_precomp_batch(keys.ops2, keys.g2_tab, keys.nwin, z2, mark, "g2_")

    # ONE device -> host copy for every accumulator of every proof
    leaves = _leaves((out4, out2))
    host = torch.cat([leaf.reshape(-1) for leaf in leaves]).cpu().numpy()
    parts, off = [], 0
    for leaf in leaves:
        parts.append(host[off : off + leaf.numel()].reshape(tuple(leaf.shape)))
        off += leaf.numel()
    out4h, out2h = _unflatten((out4, out2), iter(parts))  # (P, 4, n, 1), (P, n, 1)
    mark("fetch")

    proofs = []
    for p, (rr, ss) in enumerate(randomizers):
        g1_accs = [straus.projective_to_host(cfg.mod.G1, tuple(c[p, i] for c in out4h))
                   for i in range(4)]
        b2_acc = straus.projective_to_host(cfg.mod.G2, tuple(straus._row(c, p) for c in out2h))
        proofs.append(_assemble(cfg, pk, rr, ss, g1_accs, b2_acc))
    mark("assemble")
    return proofs


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
