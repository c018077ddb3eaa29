// K2: elementwise Montgomery product on limb-major planes.
//
// Replaces the Pallas kernel zkmember_tpu/fields/lm_pallas.py::mont_mul
// (_mont_mul_pallas_3d, kernel _kernel): out = a * b * R^-1 mod p, fully
// reduced, over (K, n, B) int32 planes of 16-bit limbs, n in {16, 24, 48}.
//
// Design: lanes on the grid's x axis, the K planes on its y axis (one grid
// for each 65,535 planes), so no thread divides an index.  One
// thread per lane: threads of a warp own consecutive lanes, so every
// limb-row load and store is coalesced.  (Two products a thread, on lanes
// a block apart, measured 9 % slower at (24, 24, 16384): their registers
// halve the blocks an SM holds.)  Operands are read in place through element
// strides over (K, limb, lane), 0 on a broadcast axis: a stage's (n, B)
// twiddles against a (3, n, B) stack, or an (n, 1) constant column, are
// never expanded in memory.  A thread packs its limbs into n/2 32-bit words
// and runs CIOS with 64-bit accumulators in registers; the TPU kernel's
// three separated schoolbook passes and Kogge-Stone carries were shaped by
// a vector unit without wide multiplies and do not carry over.
//
// Bound: bytes.  Per element the kernel moves 3 planes x n limbs x 4 B
// (two inputs, one output; 288 B at n = 24; a broadcast operand is read
// once, from cache, after its first block) and issues 2 (n/2)^2 full
// 32x32->64 multiplies (two IMADs each) and n/2 low-word ones: 588 IMADs at
// n = 24.  At the H100's 3.35 TB/s and 16.75e12 IMAD/s the bytes take longer.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

struct Strides {
  long long k, limb, lane;  // elements between neighbours on each axis; 0 = broadcast
};

constexpr int kThreads = 128;
constexpr long long kMaxGridY = 65535;

template <int N>
__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, long long B, Strides sa, Strides sb, zk::Mod<N> m) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= B) return;
  const long long k = blockIdx.y;
  zk::Fe<N> x, y, r;
  zk::load_fe<N>(x, a + k * sa.k + j * sa.lane, sa.limb);
  zk::load_fe<N>(y, b + k * sb.k + j * sb.lane, sb.limb);
  zk::fmul<N>(r, x, y, m);
  zk::store_fe<N>(r, out + k * (2 * N) * B + j, B);
}

template <int N>
int launch(const void* a, const void* b, void* out, long long K, long long B, Strides sa,
           Strides sb, const uint32_t* p_words, uint32_t np0, cudaStream_t stream) {
  zk::Mod<N> m;
  for (int i = 0; i < N; ++i) m.p[i] = p_words[i];
  m.np0 = np0;
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  for (long long k0 = 0; k0 < K; k0 += kMaxGridY) {  // one grid for at most 65,535 planes
    const long long planes = K - k0 < kMaxGridY ? K - k0 : kMaxGridY;
    mont_mul_kernel<N><<<dim3(blocks, static_cast<unsigned>(planes)), kThreads, 0, stream>>>(
        static_cast<const int32_t*>(a) + k0 * sa.k, static_cast<const int32_t*>(b) + k0 * sb.k,
        static_cast<int32_t*>(out) + k0 * (2 * N) * B, B, sa, sb, m);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// a, b: int32 device planes read at a + k*ak + limb*al + lane*aj (and b's
// strides) for k < K, limb < n16, lane < B; out: contiguous (K, n16, B).
// p_words: host array of n16/2 words of p; np0 = -p^-1 mod 2^32.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported limb count.
extern "C" int zk_mont_mul(int n16, const void* a, const void* b, void* out, long long K,
                           long long B, long long ak, long long al, long long aj,
                           long long bk, long long bl, long long bj, const uint32_t* p_words,
                           uint32_t np0, void* stream) {
  if (K * B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sa{ak, al, aj}, sb{bk, bl, bj};
  switch (n16) {
    case 16: return launch<8>(a, b, out, K, B, sa, sb, p_words, np0, s);
    case 24: return launch<12>(a, b, out, K, B, sa, sb, p_words, np0, s);
    case 48: return launch<24>(a, b, out, K, B, sa, sb, p_words, np0, s);
    default: return -1;
  }
}
