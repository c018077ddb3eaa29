// The Straus MSM's finish: the tail reduction of K1's window sums, as wide
// as K1's output, and the Horner join, as two launches.
//
// Replaces what the reference runs as XLA scans after its Pallas K1 (no
// Pallas call of its own): zkmember_tpu/msm/straus.py::tree_reduce_lanes
// (:76) and ::horner_join (:204).
//
//   in       one (W, R, n, NT) int32 plane per coordinate component: the
//            window sums (most significant window first), NT a power of two
//   scratch  point records (3 coordinates, components, words; 32-bit words)
//            of the tail's partial sums; counters: zeroed unsigned ints
//   sums     (W, R) point records: each window's lane sum
//   out      one (R, n, 1) plane per component: sum_w 16^(W-1-w) S_w
//
// Bounds.  Operations: W R (NT - 1) complete additions in the tail and,
// a row, 4 (W - 1) doublings and W - 1 additions in the join (12 and 8
// Montgomery products; three base products each over Fp2).  And latency:
// the join is a chain of 4 (W - 1) + (W - 1) dependent point operations,
// two waves of products each, 630 waves at W = 64 and 940 at BW6-761's
// W = 95.  No method that starts from the window sums has fewer dependent
// doublings.
//
// Design.  Every Montgomery product runs split over a group of lanes with
// PTX carry chains (field.cuh: gmul): 2 shuffles a word of b, carries
// resolved once at the end.  A join product takes 4 lanes (n = 24) or 8
// (n = 48), 3 words a lane: about an n/2-step chain.  The complete
// addition (RCB15 Alg. 7) and the a = 0 doubling (Alg. 9) run as two waves
// of products with field operations ("glue") between them (point.cuh:
// team_op); every shuffle and ballot takes the whole warp's mask.
//
// The tail: a group of 4 lanes an addition, 32 groups (128 threads) a
// chunk of 64 lanes of a window.  The first level reads straight from K1's
// limb-major planes (a group's lanes read limb rows of one lane,
// neighbouring groups neighbouring lanes); later levels read the other
// groups' sums in shared memory.  A chunk is halved until 8 partial sums
// are left (one warp's worth of groups: every level but a window's last
// few runs on full warps) and written as records; the last block of their
// siblings to finish (a counter a chunk of records) goes on with them, and
// so on until a chunk is the whole window, which is halved down to one sum
// and its flag set.  Blocks take the first stage's chunks from one counter
// in window order (tail_chunk, claim), so the sums come in the order the
// join needs them; W R NT / 64 chunks fill the card at R = 1 (1,024 for
// BLS12-381 G2).
//
// join_kernel: one block of 6 warps a row.  acc = S_0, then for each later
// window four doublings and acc + S_w.  Each wave's products (4 or 6, three
// base products each over Fp2) run on groups of their own; each glue output
// on a warp of its own (point.cuh: glue_warp).
//
// Two launches: the join first, then tail_kernel as its programmatic
// dependent, so the chain starts on the first window sum while the tail
// adds up the rest.  No block waits on one that may not run: a join block
// whose next S_w is not there takes the tail's next chunk itself, and
// sleeps only once every chunk is taken by a running block; the tail waits
// on nothing.  So the finish ends whether or not the two run side by side
// (launches serialised, more join blocks than the card holds).  The last
// tail block to end waits for the join (griddepcontrol.wait), so the
// stream's next kernel sees the output.  For the main paths' few rows each
// join block has an SM to itself and a small tail is paced (kOwnRows,
// kPacedLanes).  finish_in_turn runs the tail to its end and then the join
// (the same output; the two kernels' times apart).
//
#include <cuda_runtime.h>

#include "point.cuh"

namespace {

using namespace zk;

constexpr int kJoinK = 3;      // words a lane of a join group's products
constexpr int kJoinWarps = 6;  // one warp an output of the glue (point.cuh: glue_warp)
// Up to kOwnRows rows, each join block asks for kOwnBytes of shared memory,
// more than an SM can spare beside any tail block: it has its SM to
// itself, and its chain of products does not wait behind the tail's.
constexpr int kOwnRows = 8;
constexpr int kOwnBytes = 200 * 1024;
// Beside such a join, a small tail (below kPacedLanes lanes in all) asks
// for kPacedBytes a block: a few blocks an SM, so few windows are in flight
// at once, each finishes sooner, and the sums reach the join in window
// order about as fast as it takes them.  A larger tail takes the card.
constexpr long long kPacedLanes = 1ll << 19;
constexpr int kPacedBytes = 110 * 1024;
// a join that finds nothing to take and no S_w for this long is a fault
constexpr unsigned long long kStallNs = 10ull * 1000 * 1000 * 1000;

// The tail's shape (finish_cuda.TAIL_CHUNK, TAIL_KEEP): a group of 4 lanes
// an addition (n/8 words a lane of its products), 32 groups a block, 8
// partial sums kept of a chunk of 64 lanes.  The join waits for the first
// window's sum, so a tail addition's latency counts as well as its
// instructions: 4 lanes an addition measured faster there than 2
// (tools/profile_finish.py).
template <class F>
constexpr int kTailK = F::kN / 4;
constexpr int kTailGroups = 32;
template <class F>
constexpr int kTailKeep = 32 / (F::kN / kTailK<F>);  // 8

template <class F>
struct FinishArgs {
  const int32_t* in[6];
  int32_t* out[6];
  uint32_t* scratch;
  unsigned* counters;
  uint32_t* sums;
  // W R flags, one a window sum, set once the tail has written it; then the
  // count of the tail's first-stage chunks taken and of tail blocks ended
  unsigned* ready;
};

template <class F>
constexpr int kRecord = 3 * F::kC * F::kN;  // words of a point record

// words of a group's shared memory in the tail: P and Q, which M (6)
// overlays (P and Q are read only by the first wave), then V (6 kParts)
template <class F>
constexpr int kGroupWords = (6 * F::kC + 6 * F::kParts) * F::kN;

// A group's lanes: lane j holds words K j .. K j + K - 1 of each element.
template <class F, class Gr>
__device__ __forceinline__ void ld_lane(const Elems<F>& P, const int32_t* const* in,
                                        long long off, long long NT, int j) {
#pragma unroll
  for (int e = 0; e < 3 * F::kC; ++e) {
    const int32_t* p = in[e] + off;
#pragma unroll
    for (int t = 0; t < Gr::kK; ++t) {
      const int x = Gr::kK * j + t;
      const uint32_t lo = static_cast<uint32_t>(__ldg(p + (2 * x) * NT));
      const uint32_t hi = static_cast<uint32_t>(__ldg(p + (2 * x + 1) * NT));
      P.base[e * F::kN + x] = lo | (hi << 16);
    }
  }
}

// a record written by another block of this launch: read through L2
template <class F, class Gr>
__device__ __forceinline__ void ld_record(const Elems<F>& P, const uint32_t* rec, int j) {
#pragma unroll
  for (int e = 0; e < 3 * F::kC; ++e)
#pragma unroll
    for (int t = 0; t < Gr::kK; ++t) {
      const int x = e * F::kN + Gr::kK * j + t;
      P.base[x] = __ldcg(rec + x);
    }
}

template <class F, class Gr>
__device__ __forceinline__ void st_record(uint32_t* rec, const Elems<F>& P, int j) {
#pragma unroll
  for (int e = 0; e < 3 * F::kC; ++e)
#pragma unroll
    for (int t = 0; t < Gr::kK; ++t) {
      const int x = e * F::kN + Gr::kK * j + t;
      rec[x] = P.base[x];
    }
}

// The paced tail runs 2 blocks an SM (kPacedBytes), so ptxas may give a
// thread the registers of 2 blocks an SM: without the hint it kept 64 and
// spilled 84 bytes in Fp, and the main path's finish lost about 3 %.
constexpr int kTailMinBlocks = 2;
constexpr int kTailThreads = kTailGroups * 4;  // 4 lanes a group

__host__ __device__ constexpr long long chunk_of(long long NT) {
  return NT < 2 * kTailGroups ? NT : 2 * kTailGroups;
}

// The tail's next first-stage chunk, in window order, for the calling
// block (a tail or a join block alike); `total` or more once all are taken.
__device__ __forceinline__ long long claim(unsigned* next, long long total) {
  __shared__ long long t;
  __syncthreads();  // every thread has read the last claim
  if (threadIdx.x == 0) {
    const unsigned seen = *static_cast<volatile unsigned*>(next);
    t = seen < total ? atomicAdd(next, 1u) : total;
  }
  __syncthreads();
  return t;
}

// Chunk t of the tail's first stage (t / (NT / chunk) is the window and row,
// w R + r), on the block's first kTailThreads threads: any others only keep
// its barriers.  Halve the chunk to kKeep partial sums; where this block is
// the last of their siblings to finish, go on with all of theirs, stage by
// stage; the block that halves a whole window writes its sum, then its flag.
template <class F>
__device__ __forceinline__ void tail_chunk(const FinishArgs<F>& a, long long t, long long NT,
                                           long long WR, uint32_t* smem,
                                           const typename F::Consts& k) {
  constexpr int N = F::kN;
  using Gr = Group<N, kTailK<F>>;
  constexpr int G = Gr::G, kChunk = 2 * kTailGroups, kKeep = kTailKeep<F>;
  static_assert(kTailGroups * G == kTailThreads, "a group is 4 lanes");
  __shared__ int last;

  const int grp = threadIdx.x / G;
  const Gr g = Gr::of(threadIdx.x % 32);
  const GroupTeam tm{g.j};
  uint32_t* mine = smem + grp * kGroupWords<F>;
  const Elems<F> P{mine}, Q{mine + 3 * F::kC * N}, M{mine};
  const Elems<BaseOf<F>> V{mine + 6 * F::kC * N};
  // where a group that only keeps its warp in step writes (nothing reads it)
  uint32_t* junk = smem + kTailGroups * kGroupWords<F>;
  const Elems<F> JM{junk};
  const Elems<BaseOf<F>> JV{junk + 6 * F::kC * N};
  uint32_t pj[Gr::kK];
  slice<N, Gr::kK>(pj, k.m.p, g.j);

  long long w = NT;             // lanes a window has at this stage
  long long c = chunk_of(w);    // lanes this block's chunk has
  long long wr = t / (w / c), ci = t % (w / c);
  long long ibase = 0, obase = 0, cbase = 0;  // records in and out, counters
  for (bool first = true;; first = false) {
    const bool final = w <= kChunk;  // this chunk is the whole window: down to 1
    const int h = static_cast<int>(c / 2), stop = final ? 1 : kKeep;
    if (grp < (h > 0 ? h : 1)) {
      const long long lane = ci * c + grp;
      if (first) {
        ld_lane<F, Gr>(P, a.in, wr * 2 * N * NT + lane, NT, g.j);
        if (h) ld_lane<F, Gr>(Q, a.in, wr * 2 * N * NT + lane + h, NT, g.j);
      } else {
        ld_record<F, Gr>(P, a.scratch + (ibase + wr * w + lane) * kRecord<F>, g.j);
        if (h) ld_record<F, Gr>(Q, a.scratch + (ibase + wr * w + lane + h) * kRecord<F>, g.j);
      }
    }
    __syncwarp();
    // level by level: group t < hh adds the sum of group t + hh (the first
    // level: the lane h further on, in its own Q).  The other groups of a
    // warp with such a group (a window's last levels) run the addition on
    // their own P into junk, to keep the warp in step for its shuffles.
#pragma unroll 1
    for (int hh = h; hh >= stop; hh /= 2) {
      if (grp - grp % (32 / G) < hh) {
        const bool real = grp < hh;
        const Elems<F> Qh = !real ? P : hh == h ? Q : Elems<F>{smem + (grp + hh) * kGroupWords<F>};
        team_op<F>(tm, g, kAdd, real ? P : JM, P, Qh, real ? M : JM, real ? V : JV, pj, k);
      }
      __syncthreads();
    }
    if (final) {
      if (grp == 0) st_record<F, Gr>(a.sums + wr * kRecord<F>, P, g.j);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) atomicExch(a.ready + wr, 1u);  // after the fence: S_w is there
      return;
    }
    // the chunk's kKeep partial sums go on to the next stage, chunk-major
    const long long up = w / c * kKeep;  // lanes a window has at the next stage
    if (grp < kKeep)
      st_record<F, Gr>(a.scratch + (obase + wr * up + ci * kKeep + grp) * kRecord<F>, P, g.j);
    __threadfence();
    __syncthreads();
    const long long c2 = chunk_of(up), parent = ci * kKeep / c2;
    if (threadIdx.x == 0)
      last = atomicAdd(a.counters + cbase + wr * (up / c2) + parent, 1u) == c2 / kKeep - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    cbase += WR * (up / c2);
    ibase = obase;
    obase += WR * up;
    w = up;
    c = c2;
    ci = parent;
  }
}

template <class F>
__global__ void __launch_bounds__(kTailThreads, kTailMinBlocks)
    tail_kernel(FinishArgs<F> a, long long NT, long long WR, typename F::Consts k) {
  extern __shared__ __align__(16) uint32_t smem[];
  const long long chunks = WR * (NT / chunk_of(NT));
  for (long long t = claim(a.ready + WR, chunks); t < chunks; t = claim(a.ready + WR, chunks))
    tail_chunk<F>(a, t, NT, WR, smem, k);
  // the last tail block to end waits for the join, its primary, so the
  // stream's next work sees the join's output (launched in turn: no wait)
  if (threadIdx.x == 0 && atomicAdd(a.ready + WR + 1, 1u) == gridDim.x - 1)
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <class F>  // S_w, acc, M, V; then room for a tail chunk
constexpr int kJoinWords =
    (2 * kRecord<F> + 6 * F::kC * F::kN + 6 * F::kParts * F::kN + 3) / 4 * 4;

template <class F>  // shared memory of a tail block (its groups and the junk) and a join block
constexpr int kTailBytes = (kTailGroups + 1) * kGroupWords<F> * 4;
template <class F>
constexpr int kJoinBytes = kJoinWords<F> * 4 + kTailBytes<F>;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <class F>
__global__ void __launch_bounds__(kJoinWarps * 32)
    join_kernel(FinishArgs<F> a, int W, int R, long long NT, typename F::Consts k) {
  constexpr int N = F::kN;
  using Gr = Group<N, kJoinK>;
  constexpr int G = Gr::G;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned have;
  // the tail may launch at once and run beside the join
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int r = blockIdx.x;
  const long long WR = static_cast<long long>(W) * R, chunks = WR * (NT / chunk_of(NT));
  uint32_t *Sw = smem, *acc = smem + kRecord<F>;
  const Elems<F> S{Sw}, P{acc}, M{acc + kRecord<F>};
  const Elems<BaseOf<F>> V{acc + kRecord<F> + 6 * F::kC * N};
  const Gr g = Gr::of(threadIdx.x % 32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const BlockTeam tm{warp * (32 / G), lane / G, kJoinWarps * (32 / G), warp, lane};
  uint32_t pj[kJoinK];
  slice<N, kJoinK>(pj, k.m.p, g.j);
  // acc = S_0; then for each later window four doublings and + S_w.  S_w
  // goes into a register of thread x when the window starts (it lands in
  // smem before the addition, the loads fly meanwhile).  Until the tail has
  // S_w, the block takes the tail's next chunk itself; with none left it
  // sleeps, as every chunk is then on a block that runs.
  uint32_t pre = 0;
#pragma unroll 1
  for (int step = 0; step < 5 * W; ++step) {
    const int w = step / 5, kind = step % 5 == 4 ? kAdd : kDbl;
    if (step % 5 == 0) {
      const unsigned* flag = a.ready + static_cast<long long>(w) * R + r;
      unsigned long long idle = 0;  // thread 0: when it last found nothing to do
      for (;;) {
        __syncthreads();  // every thread has read the last `have`
        if (threadIdx.x == 0) have = ld_acquire(flag);
        __syncthreads();
        if (have) break;
        const long long t = claim(a.ready + WR, chunks);
        if (t < chunks) {
          tail_chunk<F>(a, t, NT, WR, smem + kJoinWords<F>, k);
          idle = 0;
        } else if (threadIdx.x == 0) {
          const unsigned long long now = now_ns();
          if (!idle) idle = now;
          if (now - idle > kStallNs) __trap();
          __nanosleep(256);
        }
      }
      if (threadIdx.x < kRecord<F>)
        pre = __ldcg(a.sums + (static_cast<long long>(w) * R + r) * kRecord<F> + threadIdx.x);
      if (step == 0) {
        if (threadIdx.x < kRecord<F>) acc[threadIdx.x] = pre;
        __syncthreads();
        step = 4;  // window 0 has no doublings: on to window 1
        continue;
      }
    }
    if (kind == kAdd) {
      if (threadIdx.x < kRecord<F>) Sw[threadIdx.x] = pre;
      __syncthreads();
    }
    team_op<F>(tm, g, kind, P, P, S, M, V, pj, k);
  }
  for (int x = threadIdx.x; x < kRecord<F>; x += blockDim.x) {
    const int e = x / N, i = x % N;  // e = coordinate * kC + component
    int32_t* o = a.out[e] + static_cast<long long>(r) * 2 * N;
    o[2 * i] = static_cast<int32_t>(acc[x] & 0xFFFFu);
    o[2 * i + 1] = static_cast<int32_t>(acc[x] >> 16);
  }
}

template <class F>
int launch(const FinishArgs<F>& a, int W, int R, long long NT, const typename F::Consts& k,
           bool in_turn, cudaStream_t stream) {
  const long long WR = static_cast<long long>(W) * R;
  const bool own = R <= kOwnRows, paced = own && WR * NT < kPacedLanes;
  const int tail_bytes = paced && kTailBytes<F> < kPacedBytes ? kPacedBytes : kTailBytes<F>;
  const int join_bytes = own && kJoinBytes<F> < kOwnBytes ? kOwnBytes : kJoinBytes<F>;
  // the largest shared memory each kernel asks for, set once a device
  static unsigned long long set = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!(set >> dev & 1)) {
    err = cudaFuncSetAttribute(tail_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTailBytes<F> > kPacedBytes ? kTailBytes<F> : kPacedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(join_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kJoinBytes<F> > kOwnBytes ? kJoinBytes<F> : kOwnBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    set |= 1ull << dev;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(WR * (NT / chunk_of(NT))));
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = tail_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = in_turn ? 0 : 1;  // beside the join, as its programmatic dependent
  if (in_turn) {
    err = cudaLaunchKernelEx(&cfg, tail_kernel<F>, a, NT, WR, k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  join_kernel<F><<<R, kJoinWarps * 32, join_bytes, stream>>>(a, W, R, NT, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!in_turn) {
    err = cudaLaunchKernelEx(&cfg, tail_kernel<F>, a, NT, WR, k);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: 6 device pointers to (W, R, n16, NT) int32 planes (x0, x1, y0, y1,
// z0, z1; the c1 entries unused for fp2 = 0); out: 6 pointers to (R, n16, 1)
// planes.  scratch: the tail's point records (finish_cuda.tail_scratch
// gives their count), counters: as many zeroed unsigned ints as it gives,
// sums: W R point records (3 C n16 / 2 words each), ready: W R + 2 zeroed
// unsigned ints.  chunk, keep: the tail's shape as the caller has it (64,
// 8).  Variants as K1's: Fp and Fp2 at n16 = 24, Fp at n16 = 48.  p_words:
// host array of n16/2 words of p; np0 = -p^-1 mod 2^32; b3 = b3c0 (+ b3c1
// u for fp2, b3c1 = 0 or b3c0), signed.  in_turn: the tail to its end,
// then the join (else the join, the tail beside it).  Two launches on
// `stream`; returns cudaGetLastError() after them, or -1 for an
// unsupported shape.
extern "C" int zk_msm_finish(int n16, int fp2, const void* const* in, void* const* out,
                             void* scratch, void* counters, void* sums, void* ready, int W, int R,
                             long long NT, int chunk, int keep, const uint32_t* p_words,
                             uint32_t np0, int b3c0, int b3c1, int in_turn, void* stream) {
  const bool pow2 = NT > 0 && (NT & (NT - 1)) == 0;
  const bool variant = n16 == 24 || (n16 == 48 && !fp2);
  // b3 over Fp2 of the form c (1 + u) (BLS12-381 G2: 12 + 12 u), as the glue takes it
  if (!variant || !pow2 || W < 1 || R < 1 || (fp2 && b3c1 != 0 && b3c1 != b3c0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto field) {
    using F = decltype(field);
    FinishArgs<F> a;
    for (int i = 0; i < 6; ++i) {
      a.in[i] = static_cast<const int32_t*>(in[i]);
      a.out[i] = static_cast<int32_t*>(out[i]);
    }
    a.scratch = static_cast<uint32_t*>(scratch);
    a.counters = static_cast<unsigned*>(counters);
    a.sums = static_cast<uint32_t*>(sums);
    a.ready = static_cast<unsigned*>(ready);
    typename F::Consts k;
    for (int i = 0; i < F::kN; ++i) k.m.p[i] = p_words[i];
    k.m.np0 = np0;
    k.magic = ~0ull / (static_cast<unsigned long long>(p_words[F::kN - 1]) + 1);
    k.b3c0 = b3c0;
    k.b3c1 = b3c1;
    if (chunk != 2 * kTailGroups || keep != kTailKeep<F>) return -1;
    return launch<F>(a, W, R, NT, k, in_turn != 0, s);
  };
  if (n16 == 48) return run(zk::FinishField<24, 1>{});
  return fp2 ? run(zk::FinishField<12, 2>{}) : run(zk::FinishField<12, 1>{});
}
