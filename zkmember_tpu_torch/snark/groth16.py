"""Groth16: setup, the v1 (batch-major) prover and the verifier.

Counterpart of zkmember_tpu.snark.groth16 (ark-groth16 semantics):

  host    toxic waste, QAP evaluation at tau (sparse, bignum), the verifier;
  device  the key points as fixed-base scalar multiplications from
          precomputed window tables (setup), the coset-NTT H pipeline and
          the five classified MSMs of the v1 prover (``msm.msm``); every
          field product is kernel K3 (``fields.field_cuda``) on the card.

Keys also come from a checkpoint (``utils.checkpoint``) or from numpy
planes (``snark.prove_lm.keys_from_numpy``); the limb-major prover
``snark.prove_lm`` takes the same ``ProvingKey``.  Both pairing stacks
are ported: BLS12-381 (G2 over Fq2) and BW6-761 (G2 over Fq).

R1CS -> QAP uses the libsnark/ark construction: the evaluation domain is
sized to num_constraints + num_instance and each instance variable i gets
an extra Lagrange term L_{nc+i} in its A-polynomial (input consistency).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.msm import msm as msmmod
from zkmember_tpu_torch.ntt import ntt as nttmod
from zkmember_tpu_torch.r1cs.cs import ConstraintSystem
from zkmember_tpu_torch.utils import obs
from zkmember_tpu_torch.utils import rng as frng


class PairingConfig:
    """What Groth16 needs to know about a pairing-friendly curve (host side).

    g2_spec is the field of G2's coordinates: an ``Fp2Spec`` (BLS12-381) or
    the base field itself (BW6-761, whose twist is defined over Fq)."""

    def __init__(self, name, fr_spec, fq_spec, g2_spec, mod):
        self.name = name
        self.fr_spec = fr_spec  # scalar field
        self.fq_spec = fq_spec  # G1 coordinates
        self.g2_spec = g2_spec  # G2 coordinates
        self.g2_fp2 = isinstance(g2_spec, fs.Fp2Spec)
        self.mod = mod  # host curve module (G1, G2, multi_pairing, ...)
        self.r = mod.R

    def F1(self, device) -> dv.FpOps:
        """Batch-major field ops of G1's coordinates on `device`."""
        return dv.FpOps(self.fq_spec, device)

    def F2(self, device) -> dv.FpOps | dv.Fp2Ops:
        if self.g2_fp2:
            return dv.Fp2Ops(self.g2_spec, device)
        return dv.FpOps(self.g2_spec, device)

    def g1_from_host(self, pts, device) -> msmmod.PointArray:
        return msmmod.g1_points_from_host(self.fq_spec, self.mod.G1, pts, device)

    def g2_from_host(self, pts, device) -> msmmod.PointArray:
        if self.g2_fp2:
            return msmmod.g2_points_from_host(self.g2_spec, self.mod.G2, pts, device)
        return msmmod.g1_points_from_host(self.g2_spec, self.mod.G2, pts, device)


_CONFIGS: dict = {}


def _bls_config() -> PairingConfig:
    from zkmember_tpu_torch.curves import bls12_381 as mod

    return PairingConfig("bls12_381", fs.BLS_FR, fs.BLS_FQ, fs.BLS_FQ2, mod)


def _bw6_config() -> PairingConfig:
    from zkmember_tpu_torch.curves import bw6_761 as mod

    return PairingConfig("bw6_761", fs.BW6_FR, fs.BW6_FQ, fs.BW6_FQ, mod)


_BUILDERS = {"bls12_381": _bls_config, "bw6_761": _bw6_config}


def pairing_config(name: str) -> PairingConfig:
    if name not in _BUILDERS:
        raise ValueError(f"unsupported curve {name!r} (bls12_381 or bw6_761)")
    if name not in _CONFIGS:
        _CONFIGS[name] = _BUILDERS[name]()
    return _CONFIGS[name]


# ---------------------------------------------------------------------------
# keys / proof containers
# ---------------------------------------------------------------------------


@dataclass
class PointPlanes:
    """Affine points as batch-major Montgomery limb rows: x, y are (k, n)
    host uint32 numpy arrays or int32 tensors on a device (what setup
    leaves there), or (c0, c1) pairs of them for Fp2 coordinates.
    ``msm.PointArray.from_planes`` and ``prove_lm.Groth16KeysLM`` take
    either."""

    x: object
    y: object

    def __len__(self):
        c = self.x
        while isinstance(c, tuple):
            c = c[0]
        return c.shape[0]


@dataclass
class VerifyingKey:
    curve: str
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # host affine, len = num_instance


@dataclass
class ProvingKey:
    curve: str
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: PointPlanes  # u_i(tau) G1 for i in a_nonzero
    b_g1_query: PointPlanes
    b_g2_query: PointPlanes
    h_query: PointPlanes  # tau^k Z / delta G1, k < M - 1
    l_query: PointPlanes  # witness vars with nonzero L scalar only
    a_nonzero: list
    b_nonzero: list
    l_nonzero: list  # witness-relative indices with nonzero L scalar
    domain_size: int
    num_instance: int


@dataclass
class Proof:
    curve: str
    a: tuple  # G1 affine
    b: tuple  # G2 affine
    c: tuple  # G1 affine


# ---------------------------------------------------------------------------
# witness evaluation (host)
# ---------------------------------------------------------------------------


def _matrix_evals(cs: ConstraintSystem, M: int):
    """Extended-domain evaluations of <A_j,z>, <B_j,z>, <C_j,z> (host ints)."""
    nc, ni = cs.num_constraints, cs.num_instance
    a = [0] * M
    b = [0] * M
    c = [0] * M
    for j in range(nc):
        a[j] = cs.lc_value(cs.A[j])
        b[j] = cs.lc_value(cs.B[j])
        c[j] = cs.lc_value(cs.C[j])
    for i in range(ni):  # input-consistency rows
        a[nc + i] = cs.values[i]
    return a, b, c


def _matrix_evals_native(cs: ConstraintSystem, M: int, nf):
    """Native CSR Montgomery matvecs -> (da, db, dc) as (M, n16) uint32
    Montgomery limb planes (host numpy), plus the witness as canonical u64
    rows.  The CSR structure and coefficients are cached on the cs."""
    from zkmember_tpu_torch import native as zknative

    nc, ni = cs.num_constraints, cs.num_instance
    cache = getattr(cs, "_native_csr", None)
    if cache is None:
        (ia, ca, va), (ib, cb, vb), (ic, cc, vc) = cs.to_sparse()
        cache = cs._native_csr = [
            (ind, col, nf.to_mont(zknative.ints_to_u64(vals, nf.nl)))
            for ind, col, vals in ((ia, ca, va), (ib, cb, vb), (ic, cc, vc))
        ]
    z_rows = zknative.ints_to_u64(cs.values, nf.nl)
    z_mont = nf.to_mont(z_rows)

    def eval_one(entry, instance_rows: bool):
        ind, col, coeffs = entry
        ev = nf.csr_matvec(ind, col, coeffs, z_mont)  # (nc, nl) mont
        full = np.zeros((M, nf.nl), "<u8")
        full[:nc] = ev
        if instance_rows:
            full[nc : nc + ni] = z_mont[:ni]
        return zknative.u64_to_u16_planes(full)

    return eval_one(cache[0], True), eval_one(cache[1], False), eval_one(cache[2], False), z_rows


# ---------------------------------------------------------------------------
# QAP evaluation at tau (host bignum; sparse)
# ---------------------------------------------------------------------------


def _batch_inverse(vals, p):
    """Montgomery's trick: n inversions for one inversion + 3n products."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * vals[i] % p
    return out


def qap_evaluate_at(cs: ConstraintSystem, domain: nttmod.Domain, tau: int):
    """u_i(tau), v_i(tau), w_i(tau) per variable, and Z(tau).

    Lagrange basis L_j(tau) = Z(tau)/M * w^j / (tau - w^j); instance rows
    add L_{nc+i} into u_i (input consistency)."""
    p = cs.p
    M = domain.size
    nc, ni, nv = cs.num_constraints, cs.num_instance, cs.num_variables
    if nc + ni > M:
        raise ValueError("the domain is smaller than constraints + instance")
    z_tau = (pow(tau, M, p) - 1) % p
    if z_tau == 0:
        raise ValueError("tau hit the domain (resample)")
    wj = [1] * M
    for j in range(1, M):
        wj[j] = wj[j - 1] * domain.w % p
    denoms = _batch_inverse([(tau - w) % p for w in wj], p)
    zm = z_tau * pow(M, -1, p) % p
    L = [zm * wj[j] % p * denoms[j] % p for j in range(M)]

    u = [0] * nv
    v = [0] * nv
    w = [0] * nv
    for j in range(nc):
        lj = L[j]
        for i, c in cs.A[j].items():
            u[i] = (u[i] + c * lj) % p
        for i, c in cs.B[j].items():
            v[i] = (v[i] + c * lj) % p
        for i, c in cs.C[j].items():
            w[i] = (w[i] + c * lj) % p
    for i in range(ni):
        u[i] = (u[i] + L[nc + i]) % p
    return u, v, w, z_tau


# ---------------------------------------------------------------------------
# fixed-base batched scalar multiplication on the device (key generation)
# ---------------------------------------------------------------------------


_FIXED_TABLES: dict = {}


def _fixed_base_table(cfg, base_host, curve, g2: bool, device):
    """Window tables table[w][d] = d 16^w G, (n_windows, 16) projective
    points built on the host once per (curve, group, device).  The d = 0
    entries are the identity class (X = 0, Z = 0, Y of G): on an a = 0
    curve Z = 0 forces X = 0, and the complete law absorbs any (0, y, 0)."""
    key = (cfg.name, g2, str(torch.device(device)))
    if key not in _FIXED_TABLES:
        c = msmmod.WINDOW_BITS
        nwin = (cfg.r.bit_length() + c - 1) // c
        flat = []
        step = base_host
        for _ in range(nwin):
            acc = None
            for _ in range(1 << c):
                flat.append(acc)  # d 16^w G, None for d = 0
                acc = curve.add(acc, step) if acc is not None else step
            for _ in range(c):
                step = curve.double(step)
        pts = [base_host if p is None else p for p in flat]
        tbl = cfg.g2_from_host(pts, device) if g2 else cfg.g1_from_host(pts, device)
        F = tbl.F
        ident = torch.as_tensor([p is None for p in flat], device=F.device)
        X = F.select(ident, F.zeros((len(pts),)), tbl.x)
        Z = F.select(ident, F.zeros((len(pts),)), F.ones((len(pts),)))
        resh = lambda cc: cc.reshape((nwin, 1 << c) + cc.shape[1:])  # noqa: E731
        _FIXED_TABLES[key] = tuple(cdv._map(resh, t) for t in (X, tbl.y, Z)) + (nwin,)
    return _FIXED_TABLES[key]


def _fixed_base_kernel(ops, digits, TX, TY, TZ):
    """digits: (B, nwin) window digits, least significant first; T*:
    (nwin, 16) window tables.  One complete addition per window and no
    doubling: acc += table[w][d_w]; digit-0 entries are the identity."""
    acc = cdv.swp_identity(ops, (digits.shape[0],))
    for w in range(digits.shape[1]):
        dig = digits[:, w]
        Q = tuple(cdv.gather_coord(cdv._map(lambda c: c[w], t), dig) for t in (TX, TY, TZ))
        acc = cdv.swp_add(ops, acc, Q)
    return acc


def _fixed_base_mul_device(cfg, F, base_host, curve, scalars, g2=False):
    """[s G for s in scalars] as device affine Montgomery rows (x, y) and a
    host is-identity mask, in tiles of ``msm.tile`` rows on F's device."""
    if not scalars:
        return None, None, np.zeros((0,), bool)
    TX, TY, TZ, nwin = _fixed_base_table(cfg, base_host, curve, g2, F.device)
    ops = msmmod.sw_ops_for_curve(F, curve)
    c = msmmod.WINDOW_BITS
    dg = msmmod.scalars_to_digits_np([s % cfg.r for s in scalars], nwin * c)
    dg = np.ascontiguousarray(dg[:, ::-1])  # least significant window first
    xs, ys, infs = [], [], []
    for s, e in msmmod._chunks(len(scalars), msmmod.tile(F.device)):
        J = _fixed_base_kernel(ops, torch.as_tensor(dg[s:e], device=F.device), TX, TY, TZ)
        x, y, inf = cdv.swp_to_affine(ops, J)
        xs.append(x)
        ys.append(y)
        infs.append(inf.cpu().numpy())

    def join(parts):
        if isinstance(parts[0], tuple):
            return tuple(join([p[i] for p in parts]) for i in range(len(parts[0])))
        return torch.cat(parts)

    return join(xs), join(ys), np.concatenate(infs)


def _fixed_base_mul_g1(cfg, F, scalars):
    """[s G for s in scalars] on G1 -> host affine points (small batches,
    the verifying key's gamma_abc)."""
    if not scalars:
        return []
    g1 = cfg.mod.G1
    x, y, inf = _fixed_base_mul_device(cfg, F, cfg.mod.G1_GEN, g1, scalars)
    xs = cfg.fq_spec.from_mont_host(x.cpu().numpy())
    ys = cfg.fq_spec.from_mont_host(y.cpu().numpy())
    return [None if i else (g1.field(xv), g1.field(yv)) for xv, yv, i in zip(xs, ys, inf)]


def _host_planes(cfg, pts, g2: bool) -> PointPlanes:
    """Host affine points -> host uint32 Montgomery planes."""
    spec = cfg.fq_spec
    if g2 and cfg.g2_fp2:
        comp = lambda i, j: spec.to_mont_host([p[i].coeffs[j].v for p in pts])  # noqa: E731
        return PointPlanes((comp(0, 0), comp(0, 1)), (comp(1, 0), comp(1, 1)))
    return PointPlanes(spec.to_mont_host([p[0].v for p in pts]),
                       spec.to_mont_host([p[1].v for p in pts]))


def setup(cs: ConstraintSystem, curve: str = "bls12_381", rng=None, host: bool = False,
          device=None, phase_times: dict | None = None):
    """Circuit-specific setup: sample the toxic waste (alpha, beta, gamma,
    delta, tau, in that order), evaluate the QAP at tau on the host and
    make the key points by device fixed-base multiplications.

    Returns (pk, vk); pk's queries are PointPlanes of int32 rows on the
    device.  host=True makes them with host scalar multiplications into
    host planes instead (tiny circuits).  rng defaults to OS entropy; tests
    and the CLI pass utils.rng.test_rng().  phase_times: a dict to receive
    host seconds per phase (synchronizing the card between phases)."""
    cfg = pairing_config(curve)
    rng = rng or frng.secure_rng()
    r = cfg.r
    mod = cfg.mod
    dev = None if host else devmod.resolve(device)

    alpha, beta, gamma, delta, tau = (frng.nonzero_field_element(rng, r) for _ in range(5))
    mark = obs.PhaseClock(phase_times, dev)
    M = msmmod._next_pow2(cs.num_constraints + cs.num_instance)
    domain = nttmod.Domain.get(cfg.fr_spec, M)
    u, v, w, z_tau = qap_evaluate_at(cs, domain, tau)

    ni, nv = cs.num_instance, cs.num_variables
    gamma_inv = pow(gamma, -1, r)
    delta_inv = pow(delta, -1, r)
    abc = [(beta * u[i] + alpha * v[i] + w[i]) % r for i in range(nv)]
    gamma_abc = [abc[i] * gamma_inv % r for i in range(ni)]
    l_scalars = [abc[i] * delta_inv % r for i in range(ni, nv)]
    taupow = [1] * (M - 1)
    for k in range(1, M - 1):
        taupow[k] = taupow[k - 1] * tau % r
    h_scalars = [taupow[k] * z_tau % r * delta_inv % r for k in range(M - 1)]
    # zero scalars contribute nothing and would be the identity, which the
    # dense affine queries cannot hold: drop them
    a_nonzero = [i for i in range(nv) if u[i] % r]
    b_nonzero = [i for i in range(nv) if v[i] % r]
    l_nonzero = [i for i in range(len(l_scalars)) if l_scalars[i]]
    mark("qap")

    g1, g2 = mod.G1, mod.G2
    G, H = mod.G1_GEN, mod.G2_GEN
    if host:
        def query(scalars, g2_query=False):
            crv, base = (g2, H) if g2_query else (g1, G)
            pts = [crv.mul(s % r, base) for s in scalars]
            if any(p is None for p in pts):
                raise ValueError("zero scalar leaked into a dense query")
            return _host_planes(cfg, pts, g2_query)

        gamma_abc_pts = [g1.mul(s % r, G) for s in gamma_abc]
    else:
        _fixed_base_table(cfg, G, g1, False, dev)
        _fixed_base_table(cfg, H, g2, True, dev)
        mark("fixed_base_tables")

        def query(scalars, g2_query=False):
            F, crv, base = (cfg.F2(dev), g2, H) if g2_query else (cfg.F1(dev), g1, G)
            x, y, inf = _fixed_base_mul_device(cfg, F, base, crv, scalars, g2_query)
            if inf.any():
                raise ValueError("zero scalar leaked into a dense query")
            return PointPlanes(x, y)

        gamma_abc_pts = _fixed_base_mul_g1(cfg, cfg.F1(dev), gamma_abc)
    mark("gamma_abc")

    a_query = query([u[i] for i in a_nonzero])
    mark("a_query")
    b_g1_query = query([v[i] for i in b_nonzero])
    mark("b_g1_query")
    b_g2_query = query([v[i] for i in b_nonzero], g2_query=True)
    mark("b_g2_query")
    h_query = query(h_scalars)
    mark("h_query")
    l_query = query([l_scalars[i] for i in l_nonzero])
    mark("l_query")

    vk = VerifyingKey(
        curve=curve,
        alpha_g1=g1.mul(alpha, G),
        beta_g2=g2.mul(beta, H),
        gamma_g2=g2.mul(gamma, H),
        delta_g2=g2.mul(delta, H),
        gamma_abc_g1=gamma_abc_pts,
    )
    pk = ProvingKey(
        curve=curve, vk=vk, beta_g1=g1.mul(beta, G), delta_g1=g1.mul(delta, G),
        a_query=a_query, b_g1_query=b_g1_query, b_g2_query=b_g2_query,
        h_query=h_query, l_query=l_query, a_nonzero=a_nonzero, b_nonzero=b_nonzero,
        l_nonzero=l_nonzero, domain_size=M, num_instance=ni,
    )
    mark("vk")
    return pk, vk


# ---------------------------------------------------------------------------
# v1 prove: batch-major H pipeline and classified MSMs
# ---------------------------------------------------------------------------


def _h_kernel(domain: nttmod.Domain, a, b, c, zh_inv):
    """Coset-evaluation H pipeline on (M, n) Montgomery rows: coefficients
    of (A B - C) / Z_H.  The three transforms of each step run stacked."""
    spec = domain.spec
    ev = nttmod.coset_ntt(domain, nttmod.intt(domain, torch.stack([a, b, c])))
    hh = dv.sub(spec, dv.mont_mul(spec, ev[0], ev[1]), ev[2])
    hh = dv.mont_mul(spec, hh, zh_inv)
    return nttmod.coset_intt(domain, hh)


def prove(pk: ProvingKey, cs: ConstraintSystem, rng=None, device=None,
          phase_times: dict | None = None) -> Proof:
    """Groth16 prove on the batch-major stack: witness -> H via coset NTTs
    -> five classified MSMs (``msm.msm``) -> host assembly.

    rng defaults to OS entropy for the randomizers r, s; tests pass
    utils.rng.test_rng().  phase_times: a dict to receive host seconds per
    phase (synchronizing the card between phases); None adds no
    synchronization.  ZKMEMBER_TRACE (read at each call) set: every
    phase's line goes to stderr as '# {"phase": name, "s": seconds}', then
    the phase table."""
    from zkmember_tpu_torch import native as zknative

    cfg = pairing_config(pk.curve)
    rng = rng or frng.secure_rng()
    r_mod = cfg.r
    g1, g2 = cfg.mod.G1, cfg.mod.G2
    rr = frng.field_element(rng, r_mod)
    ss = frng.field_element(rng, r_mod)
    dev = devmod.resolve(device)
    prof = obs.trace_profiler()
    mark = obs.PhaseClock(phase_times, dev, prof)

    spec = cfg.fr_spec
    M = pk.domain_size
    domain = nttmod.Domain.get(spec, M)
    nf = zknative.NativeField.get(spec.p, spec.n)
    if nf is not None:
        da, db, dc, z_rows = _matrix_evals_native(cs, M, nf)
    else:
        da, db, dc = (spec.to_mont_host(v) for v in _matrix_evals(cs, M))
    da, db, dc = (msmmod._to_device(x, dev) for x in (da, db, dc))
    mark("matrix_evals")
    zh_inv = dv.FpOps(spec, dev).const(pow(domain.vanishing_on_coset(), -1, spec.p))
    h_dev = _h_kernel(domain, da, db, dc, zh_inv)
    mark("h_kernel")
    h_planes = h_dev.cpu().numpy().astype(np.uint32)
    if nf is not None:
        h = nf.from_mont(zknative.u16_planes_to_u64(h_planes))[: M - 1]
        za = z_rows[pk.a_nonzero]
        zb = z_rows[pk.b_nonzero]
        zl = z_rows[[pk.num_instance + i for i in pk.l_nonzero]]
    else:
        z = cs.values
        h = spec.from_mont_host(h_planes)[: M - 1]
        za = [z[i] for i in pk.a_nonzero]
        zb = [z[i] for i in pk.b_nonzero]
        zl = [z[pk.num_instance + i] for i in pk.l_nonzero]
    mark("h_to_host")

    F1, F2 = cfg.F1(dev), cfg.F2(dev)

    def run(name, F, curve, planes, scalars):
        out = msmmod.msm(msmmod.PointArray.from_planes(F, curve, planes), scalars, r_mod)
        mark(name)
        return out

    a_acc = run("msm_a", F1, g1, pk.a_query, za)
    b1_acc = run("msm_b1", F1, g1, pk.b_g1_query, zb)
    b2_acc = run("msm_b2", F2, g2, pk.b_g2_query, zb)
    h_acc = run("msm_h", F1, g1, pk.h_query, h)
    l_acc = run("msm_l", F1, g1, pk.l_query, zl)

    A = g1.add(g1.add(pk.vk.alpha_g1, a_acc), g1.mul(rr, pk.delta_g1))
    B2 = g2.add(g2.add(pk.vk.beta_g2, b2_acc), g2.mul(ss, pk.vk.delta_g2))
    B1 = g1.add(g1.add(pk.beta_g1, b1_acc), g1.mul(ss, pk.delta_g1))
    C = g1.add(l_acc, h_acc)
    C = g1.add(C, g1.mul(ss, A))
    C = g1.add(C, g1.mul(rr, B1))
    C = g1.add(C, g1.mul((-rr * ss) % r_mod, pk.delta_g1))
    mark("assemble")
    if prof is not None:
        prof.dump()
    return Proof(curve=pk.curve, a=A, b=B2, c=C)


# ---------------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------------


def verify(vk: VerifyingKey, public_inputs: list[int], proof: Proof) -> bool:
    """3-pairing product check on the host:
    e(A,B) = e(alpha,beta) e(IC,gamma) e(C,delta).

    Public inputs exclude the leading ONE."""
    cfg = pairing_config(vk.curve)
    mod = cfg.mod
    g1 = mod.G1
    if len(public_inputs) + 1 != len(vk.gamma_abc_g1):
        raise ValueError(
            f"expected {len(vk.gamma_abc_g1) - 1} public inputs, got {len(public_inputs)}"
        )
    ic = vk.gamma_abc_g1[0]
    for x, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        ic = g1.add(ic, g1.mul(int(x) % cfg.r, pt))
    one = mod.multi_pairing(
        [
            (proof.a, proof.b),
            (g1.neg(vk.alpha_g1), vk.beta_g2),
            (g1.neg(ic), vk.gamma_g2),
            (g1.neg(proof.c), vk.delta_g2),
        ]
    )
    return one == type(one).one()
