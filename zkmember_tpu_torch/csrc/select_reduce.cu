// K1: fused Straus window select plus lane reduction.
//
// Replaces the Pallas kernel zkmember_tpu/msm/pallas_msm.py::select_reduce
// (kernel _kernel; in-kernel _fadd/_fsub/_fmul/_fmul_small/_rcb_add/
// _swp_add/_swp_add_fp2).  For every window w, proof p and row r it picks,
// at each lane i, the table entry tab[digit(w, p, r, i)] = [digit] P_i and
// sums the lanes of each thread with complete projective additions (RCB
// a = 0).  The P proofs of a batch share the table.
//
//   tab     (16, R, B, 3 C n/2) 32-bit words: entry e of lane i of row r
//           as one contiguous record, coordinates X, Y, Z, each of C = 1
//           (Fp) or 2 (Fp2) components of n/2 words; entry 0 = identity
//           (the wrapper packs the reference's (16, R, n, B) limb planes)
//   digits  (W, P, R, B) int32 in [0, 16), most significant window first
//   out     one (W, P, R, n, B / L) int32 plane per component
//
// Design.  Every (window, proof, row, lane tile) is independent, so all of
// them are on the grid: one warp per (window, tile, proof), 4 warps a block
// for Fp and 2 for Fp2, blockIdx.y the row.  The proof (the reference's
// proof-batch axis; digits and outputs are indexed by (p, r), the table by
// r only) is the fastest-varying part of the warp index, so the P proofs of
// one (window, tile) run side by side and share the table records their
// digits have in common (a third of a proof's digits are 0, the boolean
// lanes' and the padding's).  That measured 6 % faster than the proof on
// blockIdx.z for Fp at P = 4 and 8 on the digits of real batches, and
// 1 % for Fp2 (H100 80GB HBM3 at 700 W, PERF.md).
// Thread j of tile t owns lanes t*32L + k*32 + j for k < L (a
// warp's loads are coalesced) and sums its L selections in order into
// output lane t*32 + j; the narrow tail reduction (msm_finish.cu) sums the
// B / L output lanes.  A warp-level halving tree inside the tile would
// leave 2/3 of the lanes idle (6 addition times for 63 additions at
// L = 2); per-thread sums keep every lane busy for L - 1 additions.  The
// running sum and the addition's temporaries live in shared memory
// (point.cuh), so nothing spills; shared memory (9 or 12 slots a thread,
// see kQSlots) sets the occupancy: 4 blocks an SM for 24-word elements
// (Fp2, and Fp at n = 48), 3 for 12-word ones.
// The lanes of a warp select different entries, so a warp's loads scatter
// over 16 entries: with one record per lane each thread reads its entry
// in 16-byte loads, where limb planes would cost a 32-byte sector for
// each 4-byte limb.
// The plain version in select_reduce_cuda.py adds in the same order, so
// the two agree limb for limb.
//
// Bound: operations.  Each output lane costs L - 1 complete additions
// (12 field products, 36 base products for Fp2) against one table record
// read per lane (144 B for Fp at n = 24, 288 B for Fp2 and for Fp at
// n = 48); the table (151 MB for the 16-member BLS12-381 G1 key, 604 MB
// for BW6-761's) exceeds the 50 MB L2, hence the proofs' order.  A 24-word
// CIOS product costs about four times a 12-word one.
#include <cuda_runtime.h>

#include "point.cuh"

namespace {

constexpr int kWarp = 32;

struct Planes {
  int32_t* out[6];
};

// The block's shape follows the words of an element, not the field's
// kind: Fp at n = 24 has 12-word elements, Fp2 at n = 24 and Fp at n = 48
// (BW6-761) 24-word ones, so the latter two share one design.
// Where the selected entry Q of an addition is read from.  24 words:
// straight from its record in global memory as the addition needs it; the
// three slots this saves give an SM a fourth block (Fp2: 5.6 ms to 3.9 ms
// at the proof's G2 shape).  12 words: copied into three shared slots,
// which measured about 4 % faster than the record reads at the proof's G1
// shape (4.80 against 5.02 ms; a 12-word product is short, so the reads'
// latency shows).  Both on an H100 80GB HBM3 at a 700 W power limit.
template <class F>
constexpr bool kQSlots = zk::Slots<F>::kWords <= 12;
template <class F>
constexpr int kSlots = kQSlots<F> ? 12 : 9;  // P, [Q,] six temporaries
template <class F>
constexpr int kThreads = (kQSlots<F> ? 4 : 2) * kWarp;
template <class F>
constexpr int kSmemBytes = kThreads<F> * kSlots<F> * zk::Slots<F>::kWords * 4;
template <class F>
constexpr int kBlocksPerSm = 227 * 1024 / (kSmemBytes<F> + 1024);

template <class F>
__global__ void __launch_bounds__(kThreads<F>, kBlocksPerSm<F>)
    select_reduce_kernel(const uint32_t* __restrict__ tab, const int32_t* __restrict__ digits,
                         Planes pl, int W, int proofs, int R, long long B, int L,
                         typename F::Consts consts) {
  extern __shared__ uint32_t smem[];
  const int j = threadIdx.x % kWarp;
  const long long tiles = B / (static_cast<long long>(kWarp) * L);
  const long long gp = (static_cast<long long>(blockIdx.x) * kThreads<F> + threadIdx.x) / kWarp;
  if (gp >= W * tiles * proofs) return;  // whole warps only; no block-wide barrier below
  const long long g = gp / proofs;  // the P proofs of one (window, tile) side by side
  const int p = static_cast<int>(gp - g * proofs);
  const int w = static_cast<int>(g / tiles);
  const long long t = g - w * tiles;
  const int r = blockIdx.y;
  const long long pr = static_cast<long long>(p) * R + r;  // (proof, row)
  const zk::Slots<F> all{smem + threadIdx.x, kThreads<F>};
  const zk::Slots<F> P = all.at(0), T = all.at(3);
  constexpr int kRecord = 3 * zk::Slots<F>::kWords;  // words of one table entry
  const int32_t* dig = digits + (static_cast<long long>(w) * proofs * R + pr) * B;
  const long long lane0 = t * kWarp * L + j;
  auto record = [&](int k) {  // table entry selected at this thread's k-th lane
    const long long lane = lane0 + static_cast<long long>(k) * kWarp;
    return zk::Record<F>{tab + ((static_cast<long long>(dig[lane]) * R + r) * B + lane) * kRecord};
  };
  zk::ld_record<F>(P, record(0));
  for (int k = 1; k < L; ++k) {
    if constexpr (kQSlots<F>) {
      const zk::Slots<F> Q = all.at(9);
      zk::ld_record<F>(Q, record(k));
      zk::thread_add<F>(P, P, Q, T, consts);
    } else {
      zk::thread_add<F>(P, P, record(k), T, consts);
    }
  }
  const long long NT = tiles * kWarp;
  const long long o =
      (static_cast<long long>(w) * proofs * R + pr) * (2 * F::kN) * NT + t * kWarp + j;
  zk::st_point<F>(pl.out, o, NT, P);
}

template <class F>
int launch(const void* tab, const void* digits, void* const* out, int W, int P, int R,
           long long B, int L, typename F::Consts consts, cudaStream_t stream) {
  Planes pl;
  for (int i = 0; i < 6; ++i) pl.out[i] = static_cast<int32_t*>(out[i]);
  const long long threads = W * (B / L) * P;  // one per output lane
  cudaError_t err = cudaFuncSetAttribute(select_reduce_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes<F>);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((threads + kThreads<F> - 1) / kThreads<F>),
            static_cast<unsigned>(R));
  select_reduce_kernel<F><<<grid, kThreads<F>, kSmemBytes<F>, stream>>>(
      static_cast<const uint32_t*>(tab), static_cast<const int32_t*>(digits), pl, W, P, R, B,
      L, consts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab: (16, R, B, 3 C n16/2) words (C = 2 for fp2, else 1), 16-byte
// aligned; digits: (W, P, R, B) int32; out: 6 device pointers (x0, x1,
// y0, y1, z0, z1; the c1 entries unused for fp2 = 0) to (W, P, R, n16,
// B / L) int32 planes; R at most 65,535 (the grid's y).  Variants: Fp and
// Fp2 at n16 = 24 (BLS12-381), Fp at n16 = 48 (BW6-761 G1 and G2).
// p_words: host array of n16/2 words; np0 = -p^-1 mod 2^32; b3 = b3c0
// (+ b3c1 u for fp2), signed.  Returns cudaGetLastError() after the
// launch, or -1 for an unsupported shape.
extern "C" int zk_select_reduce(int n16, int fp2, const void* tab, const void* digits,
                                void* const* out, int W, int P, int R, long long B, int L,
                                const uint32_t* p_words, uint32_t np0, int b3c0, int b3c1,
                                void* stream) {
  const bool variant = n16 == 24 || (n16 == 48 && !fp2);
  if (!variant || L < 1 || B % (static_cast<long long>(kWarp) * L) != 0 || R > 65535 ||
      W < 0 || P < 0 || R < 0)
    return -1;
  if (W == 0 || P == 0 || R == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto field) {
    using F = decltype(field);
    return launch<F>(tab, digits, out, W, P, R, B, L,
                     zk::make_consts<F>(p_words, np0, b3c0, b3c1), s);
  };
  if (n16 == 48) return run(zk::FpField<24>{});
  return fp2 ? run(zk::Fp2Field<12>{}) : run(zk::FpField<12>{});
}
