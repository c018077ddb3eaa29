"""Multi-device proving over torch.distributed (counterpart of zkmember_tpu.parallel.dist).

A ``Mesh`` lays the ranks of one process group out as the reference's
(dp, msm) grid: rank r sits at (r // (n / dp), r % (n / dp)).

  * axis "dp"  - independent work items (leaf batches);
  * axis "msm" - points within one MSM: each rank reduces its block, the
    per-rank partial sums ride ONE all-gather, and every rank finishes the
    short combine itself.

``torch.distributed`` needs one process a rank, where XLA owns all its
devices from one: ``run_ranks`` starts them (``spawn``, rendezvous over TCP
on 127.0.0.1), NCCL between cards and gloo between CPU processes.  NCCL
takes one card a rank, so a machine with one card runs world size 1.

Data placement: every function takes the FULL, replicated inputs on every
rank (each rank builds them from the same key or seed), takes its
contiguous block along the sharded axis in mesh-axis order, as the
reference's ``P("msm")`` does, and returns the replicated result on every
rank.  Per-rank arithmetic is the port's: the Jacobian ops of
``curves.device``, the NTT of ``ntt.ntt`` and the device hash, every
product on K3 on the card.  Collectives carry the planes' own dtypes
(int32 or int64), never uint32, which gloo refuses; a cross-rank sum is
taken in int64.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import pickle
import queue as queue_mod
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as tdist

from zkmember_tpu_torch import device as devmod
from zkmember_tpu_torch.curves import device as cdv
from zkmember_tpu_torch.fields import device as dv
from zkmember_tpu_torch.fields import limbs as lb
from zkmember_tpu_torch.fields import spec as fs
from zkmember_tpu_torch.ntt import ntt as nttmod

# Seconds a rank may wait on a collective (the process group's timeout), and
# the parent on its ranks, before the run counts as hung.
RANK_TIMEOUT_S = 900

# Collective calls by kind since the last reset (plain counts, as
# kernels.LAUNCHES counts kernel launches).
COLLECTIVES = {"all_gather": 0, "all_reduce": 0, "all_to_all": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (dp, msm) grid: the axis sizes, its
    coordinates, its device, and one process group per axis ("dp", "msm")
    and for the world ("world")."""

    shape: dict
    coords: dict
    device: torch.device
    groups: dict

    @property
    def rank(self) -> int:
        return self.coords["dp"] * self.shape["msm"] + self.coords["msm"]

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["msm"]


def make_mesh(n_devices: int | None = None, dp: int | None = None, device=None) -> Mesh:
    """The (dp, n // dp) mesh over the initialised process group of n ranks
    (n_devices, the reference's argument, must be the world size; None
    takes it).

    Every rank creates every row and column group, in the same order
    (PyTorch's rule for ``new_group``: skip one and the run hangs).  device
    defaults to the current card; NCCL goes with a card, gloo with the CPU."""
    if not tdist.is_available() or not tdist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (run_ranks starts one)")
    world = tdist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks over a world of {world}")
    dp = dp or 1
    if n % dp:
        raise ValueError(f"dp = {dp} does not divide {n} ranks")
    dev = devmod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = tdist.get_backend()
    if (backend == "nccl") != (dev.type == "cuda"):
        raise ValueError(f"the {backend} backend with ranks on {dev}: NCCL needs a card a "
                         "rank and gloo the CPU")
    m = n // dp
    i, j = divmod(tdist.get_rank(), m)
    groups = {"world": tdist.group.WORLD}
    for r in range(dp):
        g = tdist.new_group([r * m + c for c in range(m)])
        if r == i:
            groups["msm"] = g
    for c in range(m):
        g = tdist.new_group([r * m + c for r in range(dp)])
        if c == j:
            groups["dp"] = g
    return Mesh(shape={"dp": dp, "msm": m}, coords={"dp": i, "msm": j}, device=dev,
                groups=groups)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _run_rank(rank: int, world: int, port: int, kind: str, dp, fn, args):
    if kind == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    tdist.init_process_group(
        "nccl" if kind == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        out = fn(make_mesh(dp=dp, device=device), *args)
        if kind == "cuda":
            torch.cuda.synchronize(device)
        return out
    finally:
        tdist.destroy_process_group()


def _rank_process(rank, world, port, kind, dp, fn, args, threads, results):
    torch.set_num_threads(threads)
    try:
        out = _run_rank(rank, world, port, kind, dp, fn, args)
        # plain pickle: torch's multiprocessing reductions would hand the
        # tensors over by a shared-memory handle, which dies with this process
        results.put((rank, True, pickle.dumps(_to_host(out)) if rank == 0 else None))
    except BaseException:  # noqa: BLE001 - the traceback goes to the caller, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n_ranks: int, *, device=None, dp: int | None = None, args=()):
    """Run ``fn(mesh, *args)`` on each of n_ranks ranks of a new process group
    over a (dp, n_ranks // dp) mesh; returns rank 0's result (tensors moved
    to the host).

    device: "cuda" (the default: NCCL, rank r on card r) or "cpu" (gloo).
    One rank runs in this process; more are ``spawn``ed, each taking this
    process's torch thread count.  fn and args are pickled by reference:
    fn must be a module-level function of a module that a fresh interpreter
    can import.  A rank that raises makes run_ranks raise, with that rank's
    traceback; the other ranks are stopped, as they are when the ranks run
    past RANK_TIMEOUT_S.  Every rank destroys its group,
    also on failure.  Raises without a card for "cuda", and for more ranks
    than cards (NCCL refuses two ranks on one card)."""
    kind = devmod.resolve(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {kind}")
    if n_ranks < 1:
        raise ValueError("run_ranks needs at least one rank")
    if kind == "cuda" and n_ranks > torch.cuda.device_count():
        raise ValueError(f"{n_ranks} ranks on {torch.cuda.device_count()} card(s): NCCL "
                         "needs a card a rank")
    if tdist.is_available() and tdist.is_initialized():
        raise RuntimeError("a process group is already initialised in this process")
    port = _free_port()
    if n_ranks == 1:
        return _to_host(_run_rank(0, 1, port, kind, dp, fn, args))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_process, daemon=True,
                         args=(r, n_ranks, port, kind, dp, fn, args,
                               torch.get_num_threads(), results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    done: dict = {}
    failed: dict = {}
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(done) < n_ranks and not failed:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode is not None and (
                            p.exitcode != 0 or results.empty()):
                        failed[r] = f"rank {r} exited with code {p.exitcode} and no result"
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {RANK_TIMEOUT_S} s")
                continue
            (done if ok else failed)[rank] = payload
    finally:
        for p in procs:
            if len(done) < n_ranks and p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        r = min(failed)
        raise RuntimeError(f"rank {r} of {n_ranks} failed:\n{failed[r]}")
    return pickle.loads(done[0])


# ---------------------------------------------------------------------------
# collectives (each counted in COLLECTIVES)
# ---------------------------------------------------------------------------


def _check_dtype(t: torch.Tensor) -> None:
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"collectives carry int32 or int64 planes, not {t.dtype}")


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """t from every rank of group, stacked on a new leading axis in group
    rank order (the list form of all_gather, which every torch has)."""
    _check_dtype(t)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, t, group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.stack(parts)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over group's ranks, in place."""
    _check_dtype(t)
    tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return t


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Chunk d of t's leading axis (its size the group's) to rank d; chunk s
    of the result from rank s."""
    _check_dtype(t)
    t = t.contiguous()
    out = torch.empty_like(t)
    tdist.all_to_all_single(out, t, group=group)
    COLLECTIVES["all_to_all"] += 1
    return out


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for xi in x for leaf in _leaves(xi)]
    return [x]


def _unflatten(x, it):
    if isinstance(x, tuple):
        return tuple(_unflatten(xi, it) for xi in x)
    return next(it)


def all_gather_points(P, group):
    """A tuple tree of tensors (point coordinates, Fp2 pairs among them) from
    every rank of group in ONE packed all-gather: each leaf comes back with
    a new leading axis of the group's size."""
    leaves = _leaves(P)
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])
    G = all_gather_stack(flat, group)  # (D, total)
    out, off = [], 0
    for leaf in leaves:
        out.append(G[:, off : off + leaf.numel()].reshape((G.shape[0],) + tuple(leaf.shape)))
        off += leaf.numel()
    return _unflatten(P, iter(out))


def block(x, parts: int, index: int, dim: int):
    """Block `index` of `parts` equal contiguous blocks of x (tuple aware)
    along dim."""
    if isinstance(x, tuple):
        return tuple(block(xi, parts, index, dim) for xi in x)
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"{size} along dim {dim} do not split into {parts} blocks")
    return x.narrow(dim, index * (size // parts), size // parts)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


# ---------------------------------------------------------------------------
# sharded MSM: points split over the "msm" axis
# ---------------------------------------------------------------------------


def sharded_msm(F, mesh: Mesh, bits, X, Y):
    """MSM with the points split over mesh axis "msm".

    bits: (B, nbits) scalar bits, MSB first; X, Y: affine Montgomery rows
    (B, n) (pairs for Fp2), replicated; B divisible by the axis size.  Each
    rank runs ``sw_msm`` on its block; the Jacobian partials ride ONE
    all-gather; every rank sums the D partials with ``sw_tree_reduce``.
    Returns the replicated Jacobian point, batch shape (1,)."""
    D, j = mesh.shape["msm"], mesh.coords["msm"]
    bits_l = block(_as_tensor(bits, F.device), D, j, 0)
    Xl, Yl = block(X, D, j, 0), block(Y, D, j, 0)
    part = cdv.sw_msm(F, bits_l, (Xl, Yl, F.ones((bits_l.shape[0],))))
    total = cdv.sw_tree_reduce(F, all_gather_points(part, mesh.groups["msm"]))
    return tuple(cdv._map(lambda c: c[None], x) for x in total)


# ---------------------------------------------------------------------------
# sharded field sum: an integer all-reduce of limb columns, one local reduction
# ---------------------------------------------------------------------------


def sharded_field_sum(spec: fs.FieldSpec, mesh: Mesh, vals, max_log_terms: int = 9):
    """sum_i vals[i] mod p for Montgomery rows vals (B, n), split over
    "msm"; returns (1, n) in vals' dtype, replicated.

    Each rank sums its block's limb columns, the columns are summed over the
    axis in int64 (D sums of up to 2^31 overflow int32), carried into n + 2
    limbs, and the total (below 2^max_log_terms p) is reduced by a ladder
    of conditional subtractions of p << j."""
    B = vals.shape[0]
    if B > 1 << max_log_terms:
        raise ValueError(f"{B} terms exceed 2^{max_log_terms}")
    D, j = mesh.shape["msm"], mesh.coords["msm"]
    cols = block(vals, D, j, 0).to(torch.int64).sum(dim=0)  # (n,)
    cols = all_reduce_sum(cols, mesh.groups["msm"])
    nw = spec.n + 2
    wide = lb.carry(cols.view(spec.n, 1), nw)  # (n + 2, 1), below 2^max_log_terms p
    for k in range(max_log_terms, -1, -1):
        pk = lb.const_limbs(fs.int_to_limbs(spec.p << k, nw), wide.device, wide.dtype)
        diff, borrow = lb.sub_limbs(wide, pk)
        wide = torch.where((borrow == 0).unsqueeze(-2), diff, wide)
    return wide[: spec.n].view(1, spec.n).to(vals.dtype)


# ---------------------------------------------------------------------------
# sharded NTT: four steps, ONE all-to-all
# ---------------------------------------------------------------------------

_TW_CACHE: dict = {}
_TW_DEV: dict = {}


def _fourstep_twiddles(spec: fs.FieldSpec, N1: int, N2: int) -> np.ndarray:
    """(N1, N2, n) Montgomery table of w^(j1 k2), w the domain root of order
    N1 N2 (host, cached per (field, N1, N2))."""
    key = (spec.p, N1, N2)
    if key not in _TW_CACHE:
        p = spec.p
        w = nttmod.Domain.get(spec, N1 * N2).w
        _TW_CACHE[key] = np.stack([nttmod._geom_mont(spec, N2, pow(w, j1, p), 1)
                                   for j1 in range(N1)])
    return _TW_CACHE[key]


def _twiddles_on(spec: fs.FieldSpec, N1: int, N2: int, device) -> torch.Tensor:
    """The four-step table as an int32 tensor on device (put there once)."""
    key = (spec.p, N1, N2, str(device))
    if key not in _TW_DEV:
        _TW_DEV[key] = torch.as_tensor(_fourstep_twiddles(spec, N1, N2).astype(np.int64),
                                       dtype=torch.int32, device=device)
    return _TW_DEV[key]


def fourstep_shape(N: int, D: int) -> tuple[int, int]:
    """The reference's (N1, N2) for N points over D ranks: N1 about sqrt(N)
    and at least D; D must divide both."""
    if N & (N - 1) or N % (D * D):
        raise ValueError("N must be a power of two with D | N1 and D | N2")
    N1 = max(D, 1 << (N.bit_length() // 2))
    N2 = N // N1
    if N1 % D or N2 % D:
        raise ValueError(f"D = {D} must divide N1 = {N1} and N2 = {N2}")
    return N1, N2


def sharded_ntt(spec: fs.FieldSpec, mesh: Mesh, values, axis: str = "msm"):
    """NTT of the (N, n) Montgomery coefficients `values` (natural order,
    replicated) with the rows of the four-step grid split over `axis`.

    x[j1 + N1 j2] is grid row j1, column j2; each rank holds N1 / D rows:
    (1) NTTs of length N2 along its rows, (2) the twiddles w^(j1 k2) (K3),
    (3) ONE all-to-all that hands each rank all N1 rows of its N2 / D
    columns, (4) NTTs of length N1 along the columns; a final all-gather
    returns the (N, n) evaluations, natural order, on every rank."""
    D, j = mesh.shape[axis], mesh.coords[axis]
    group = mesh.groups[axis]
    N, n = values.shape
    N1, N2 = fourstep_shape(N, D)
    dom1, dom2 = nttmod.Domain.get(spec, N1), nttmod.Domain.get(spec, N2)
    x_mat = values.reshape(N2, N1, n).movedim(0, 1)  # (N1, N2, n)
    xm = block(x_mat, D, j, 0)  # (N1 / D, N2, n)
    tw = block(_twiddles_on(spec, N1, N2, values.device), D, j, 0)
    a = nttmod._fft_core_axis(dom2, xm, axis=1, inverse=False)
    b = dv.mont_mul(spec, a, tw)
    # chunk d of the k2 axis goes to rank d: lead with it for all_to_all_single
    b = all_to_all(b.reshape(N1 // D, D, N2 // D, n).movedim(1, 0), group)
    b = b.reshape(N1, N2 // D, n)  # source rank s sent rows s N1/D .. (s + 1) N1/D
    c = nttmod._fft_core_axis(dom1, b, axis=0, inverse=False)  # (N1, N2 / D, n)
    full = all_gather_stack(c, group).movedim(0, 1)  # (N1, D, N2 / D, n): k2 = d N2/D + i
    return full.reshape(N, n)  # C[k1, k2] = X[k2 + N2 k1]


# ---------------------------------------------------------------------------
# data-parallel hashing: the batch split over every rank
# ---------------------------------------------------------------------------


def sharded_two_to_one(params, mesh: Mesh, left, right):
    """Batched two-to-one Pedersen hash of canonical (B, n) digests with the
    batch split over both axes (rank r takes block r); ONE all-gather over
    the world returns the (B, n) digests on every rank."""
    from zkmember_tpu_torch.hash import pedersen as ph

    out = ph.two_to_one_device(params, block(left, mesh.size, mesh.rank, 0),
                               block(right, mesh.size, mesh.rank, 0))
    G = all_gather_stack(out, mesh.groups["world"])  # (ranks, B / ranks, n)
    return G.reshape((-1,) + tuple(out.shape[1:]))
