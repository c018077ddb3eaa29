// The Straus MSM's finish: the narrow tail reduction of the window sums and
// the Horner join, as two launches over K1's output.
//
// Replaces what the reference runs as XLA scans after its Pallas K1:
// zkmember_tpu/msm/straus.py::tree_reduce_lanes (:76) and ::horner_join
// (:204).  The port ran them as PyTorch ops over K2 (fields/lm_cuda.py): 3
// one-lane Montgomery launches and some 350 other launches per complete
// addition, 1,968 of its K2 launches per proof.  Here they run on K2's CIOS
// product (field.cuh: fmul) inside two kernels.
//
//   in      one (W, R, n, NT) int32 plane per coordinate component: the
//           window sums (most significant window first), NT a power of two
//   sums    one (W, R, n, 1) plane per component: each window's lane sum
//   out     one (R, n, 1) plane per component: sum_w 16^(W-1-w) S_w
//
// tail_kernel: one block per (window, row).  While wider than `tail` lanes
// it halves contiguously (lane i += lane i + h, through a global scratch);
// then even/odd rounds as in the plain version: thread t adds lanes 2t and
// 2t + 1, and round k adds the sums of threads t and t + 2^(k-2) for t a
// multiple of 2^(k-1), through shared memory.
//
// join_kernel: one warp per row runs the row's chain, acc = identity, then
// for each window four self-additions and acc + S_w (5 W dependent
// additions).  The six independent products of each wave of an addition
// (18 base products for Fp2) run on separate lanes (point.cuh: warp_add);
// it measured about 3.5 times faster than the chain on one thread (H100
// 80GB HBM3 at 700 W, PERF.md).
//
// The additions are in the plain version's order, so the kernel and
// finish_cuda.msm_finish_plain agree limb for limb.
//
// Variants: Fp at n = 24 (BLS12-381 G1) and n = 48 (BW6-761 G1 and G2), Fp2
// at n = 24 (BLS12-381 G2).  Fp at n = 48 has the 24-word elements of Fp2
// at n = 24, so the tail block's shared memory is the same (128 threads x
// 12 slots x 96 B = 147 KB); the join runs its six products a wave on six
// lanes, each a 24-word CIOS product, about four times a 12-word one.
//
// Bound: operations, W R (NT - 1) + 5 W R complete additions of 12
// products (36 base products for Fp2).  The join is a chain of 5 W
// dependent additions a row, so its time is latency: 320 additions of
// 7,056 IMADs (Fp) or 21,168 (Fp2) at W = 64; 475 of 27,936 (Fp at
// n = 48) at BW6-761's W = 95.
#include <cuda_runtime.h>

#include "point.cuh"

namespace {

constexpr int kSlots = 12;  // P, Q, six temporaries
constexpr int kMaxTail = 256;
// One thread per addition of the first even/odd round at the widest tail.
// A compile-time slot stride keeps the slot addresses out of registers.
constexpr int kTailThreads = kMaxTail / 2;

template <class F>
struct FinishPlanes {
  const int32_t* in[6];
  int32_t* scratch[6];
  int32_t* sums[6];
  int32_t* out[6];
};

template <class F>
__global__ void __launch_bounds__(kTailThreads, 1)
    tail_kernel(FinishPlanes<F> pl, long long NT, int tail, typename F::Consts consts) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const long long wr = blockIdx.x;  // w R + r
  const long long n2 = 2 * F::kN;
  const zk::Slots<F> all{smem + tid, kTailThreads};
  const zk::Slots<F> P = all.at(0), Q = all.at(3), T = all.at(6);

  const int32_t* cur[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) cur[i] = pl.in[i];
  long long width = NT, B = NT;
  while (B > tail) {  // contiguous halvings into the scratch planes
    const long long h = B / 2;
    for (long long i = tid; i < h; i += kTailThreads) {
      zk::ld_point<F>(P, cur, wr * n2 * width + i, width);
      zk::ld_point<F>(Q, cur, wr * n2 * width + i + h, width);
      zk::thread_add<F>(P, P, Q, T, consts);
      zk::st_point<F>(pl.scratch, wr * n2 * (NT / 2) + i, NT / 2, P);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 6; ++i) cur[i] = pl.scratch[i];
    width = NT / 2;
    B = h;
  }
  const long long base = wr * n2 * width;
  const long long m = B / 2;  // additions of the first even/odd round
  if (B == 1) {
    if (tid == 0) zk::ld_point<F>(P, cur, base, width);
  } else if (tid < m) {
    zk::ld_point<F>(P, cur, base + 2 * tid, width);
    zk::ld_point<F>(Q, cur, base + 2 * tid + 1, width);
    zk::thread_add<F>(P, P, Q, T, consts);
  }
  __syncthreads();
  for (long long h = 1; h < m; h *= 2) {
    if (tid % (2 * h) == 0 && tid < m) {
      const zk::Slots<F> partner{smem + tid + h, kTailThreads};
      zk::thread_add<F>(P, P, partner, T, consts);
    }
    __syncthreads();
  }
  if (tid == 0) zk::st_point<F>(pl.sums, wr * n2, 1, P);
}

template <class F>
__global__ void __launch_bounds__(32)
    join_kernel(FinishPlanes<F> pl, int W, int R, zk::Fe<F::kN> one, typename F::Consts consts) {
  extern __shared__ uint32_t smem[];
  constexpr int N = F::kN;
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const long long n2 = 2 * N;
  const zk::Slots<F> all{smem, 1};
  const zk::Slots<F> P = all.at(0), Q = all.at(3), M = all.at(6);
  const zk::Slots<zk::FpField<N>> V{smem + kSlots * zk::Slots<F>::kWords, 1};
  auto add = [&](const zk::Slots<F>& q) { zk::warp_add<F>(P, P, q, M, V, lane, consts); };
  // acc = the identity (0, 1, 0)
  for (int x = lane; x < 3 * zk::Slots<F>::kWords; x += 32)
    P.word(x / zk::Slots<F>::kWords, x % zk::Slots<F>::kWords) = 0u;
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) P.word(1, i) = one.w[i];
  }
  __syncwarp();
  for (int w = 0; w < W; ++w) {
#pragma unroll 1
    for (int d = 0; d < 4; ++d) add(P);
    const long long off = (static_cast<long long>(w) * R + r) * n2;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < F::kComponents; ++q)
        if (lane < N) {
          const int32_t* p = pl.sums[c * F::kComponents + q] + off;
          Q.word(c, q * N + lane) = static_cast<uint32_t>(p[2 * lane]) |
                                    (static_cast<uint32_t>(p[2 * lane + 1]) << 16);
        }
    __syncwarp();
    add(Q);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < F::kComponents; ++q)
      if (lane < N) {
        int32_t* p = pl.out[c * F::kComponents + q] + r * n2;
        const uint32_t v = P.word(c, q * N + lane);
        p[2 * lane] = static_cast<int32_t>(v & 0xFFFFu);
        p[2 * lane + 1] = static_cast<int32_t>(v >> 16);
      }
}

template <class F>
int launch(const FinishPlanes<F>& pl, int W, int R, long long NT, int tail,
           const zk::Fe<F::kN>& one, typename F::Consts consts, cudaStream_t stream) {
  const int tail_bytes = kTailThreads * kSlots * zk::Slots<F>::kWords * 4;
  cudaError_t err = cudaFuncSetAttribute(tail_kernel<F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, tail_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_kernel<F><<<W * R, kTailThreads, tail_bytes, stream>>>(pl, NT, tail, consts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int join_bytes = (kSlots * zk::Slots<F>::kWords + 6 * F::kParts * F::kN) * 4;
  join_kernel<F><<<R, 32, join_bytes, stream>>>(pl, W, R, one, consts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: 6 device pointers to (W, R, n16, NT) int32 planes (x0, x1, y0, y1,
// z0, z1; the c1 entries unused for fp2 = 0); scratch: 6 pointers to
// (W, R, n16, NT / 2) planes, used only when NT > tail; sums: 6 pointers to
// (W, R, n16, 1) planes; out: 6 pointers to (R, n16, 1) planes.  Variants
// as K1's: Fp and Fp2 at n16 = 24, Fp at n16 = 48.  p_words, one_words:
// host arrays of n16/2 words of p and of R mod p; np0 = -p^-1 mod 2^32;
// b3 = b3c0 (+ b3c1 u for fp2), signed.  Two launches on `stream`;
// returns cudaGetLastError() after them, or -1 for an unsupported shape.
extern "C" int zk_msm_finish(int n16, int fp2, const void* const* in, void* const* scratch,
                             void* const* sums, void* const* out, int W, int R, long long NT,
                             int tail, const uint32_t* p_words, uint32_t np0,
                             const uint32_t* one_words, int b3c0, int b3c1, void* stream) {
  const bool pow2 = NT > 0 && (NT & (NT - 1)) == 0;
  const bool variant = n16 == 24 || (n16 == 48 && !fp2);
  if (!variant || !pow2 || tail < 2 || tail > kMaxTail || (tail & (tail - 1)) != 0 || W < 1 ||
      R < 1)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto field) {
    using F = decltype(field);
    FinishPlanes<F> pl;
    for (int i = 0; i < 6; ++i) {
      pl.in[i] = static_cast<const int32_t*>(in[i]);
      pl.scratch[i] = static_cast<int32_t*>(scratch[i]);
      pl.sums[i] = static_cast<int32_t*>(sums[i]);
      pl.out[i] = static_cast<int32_t*>(out[i]);
    }
    zk::Fe<F::kN> one;
    for (int i = 0; i < F::kN; ++i) one.w[i] = one_words[i];
    return launch<F>(pl, W, R, NT, tail, one, zk::make_consts<F>(p_words, np0, b3c0, b3c1), s);
  };
  if (n16 == 48) return run(zk::FpField<24>{});
  return fp2 ? run(zk::Fp2Field<12>{}) : run(zk::FpField<12>{});
}
