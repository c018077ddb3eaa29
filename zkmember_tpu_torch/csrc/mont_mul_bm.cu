// K3: elementwise Montgomery product on batch-major rows.
//
// Replaces the Pallas kernel zkmember_tpu/fields/pallas_field.py::mont_mul
// (_mont_mul_pallas_2d, kernel _kernel): out = a * b * R^-1 mod p, fully
// reduced, over (rows, n) int32 rows of 16-bit limbs, n in {16, 24, 48}.
//
// Design: one thread per row, CIOS over n/2 packed 32-bit words with 64-bit
// accumulators (zk::fmul, the routine K2 runs).  The TPU kernel's MXU column
// routing, shift-accumulate mode and Kogge-Stone carries were shaped by a
// vector unit without wide multiplies and do not carry over.  A row's n
// limbs are contiguous, so a thread reads and writes its own row in n/4
// 16-byte accesses: a warp's access touches 32 rows n words apart, and the
// L1 serves the other halves of the sectors it brought in.  (Staging the
// rows through shared memory measured slower: block-wide with two barriers
// 8 %, per warp 1 %, at (6, 32, 8192, 24).)  Rows are addressed as (outer,
// inner) with an element stride for each operand on each axis, 0 on a
// broadcast axis: an (n,) constant or an (N/2, n) twiddle table against
// (3, N/2, n) rows is read in place, never expanded in memory.  The grid's
// x axis covers inner rows, its y axis the outer index (one grid for each
// 65,535), so no thread divides an index.
//
// Bound: bytes.  Per row the kernel moves 3 x n limbs x 4 B (two inputs,
// one output: 288 B at n = 24, 192 B at n = 16) and issues 2 (n/2)^2 full
// 32x32->64 multiplies (two IMADs each) and n/2 low-word ones: 588 IMADs at
// n = 24.  At the H100's 3.35 TB/s and 16.75e12 IMAD/s the bytes take longer.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

struct RowStrides {
  long long outer, row;  // elements between neighbouring outer indices and rows; 0 = broadcast
};

constexpr int kRows = 64;  // rows (threads) per block: 64 measured 5 % faster than 128
constexpr long long kMaxGridY = 65535;

// A row of N16 limbs (16-byte aligned, N16 % 4 == 0) in N16 / 4 vector loads.
template <int N16>
__device__ __forceinline__ void load_row(zk::Fe<N16 / 2>& x, const int32_t* row) {
  const int4* v = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int q = 0; q < N16 / 4; ++q) {
    const int4 t = v[q];
    x.w[2 * q] = static_cast<uint32_t>(t.x) | (static_cast<uint32_t>(t.y) << 16);
    x.w[2 * q + 1] = static_cast<uint32_t>(t.z) | (static_cast<uint32_t>(t.w) << 16);
  }
}

template <int N16>
__device__ __forceinline__ void store_row(int32_t* row, const zk::Fe<N16 / 2>& x) {
  int4* v = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int q = 0; q < N16 / 4; ++q) {
    v[q] = make_int4(static_cast<int32_t>(x.w[2 * q] & 0xFFFFu),
                     static_cast<int32_t>(x.w[2 * q] >> 16),
                     static_cast<int32_t>(x.w[2 * q + 1] & 0xFFFFu),
                     static_cast<int32_t>(x.w[2 * q + 1] >> 16));
  }
}

template <int N16>
__global__ void __launch_bounds__(kRows)
mont_mul_bm_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, long long inner, RowStrides sa, RowStrides sb,
                   zk::Mod<N16 / 2> m) {
  const long long i = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x;
  if (i >= inner) return;
  const long long o = blockIdx.y;
  zk::Fe<N16 / 2> x, y, r;
  load_row<N16>(x, a + o * sa.outer + i * sa.row);
  load_row<N16>(y, b + o * sb.outer + i * sb.row);
  zk::fmul<N16 / 2>(r, x, y, m);
  store_row<N16>(out + (o * inner + i) * N16, r);
}

template <int N16>
int launch(const void* a, const void* b, void* out, long long outer, long long inner,
           RowStrides sa, RowStrides sb, const uint32_t* p_words, uint32_t np0,
           cudaStream_t stream) {
  zk::Mod<N16 / 2> m;
  for (int i = 0; i < N16 / 2; ++i) m.p[i] = p_words[i];
  m.np0 = np0;
  const unsigned blocks = static_cast<unsigned>((inner + kRows - 1) / kRows);
  for (long long o0 = 0; o0 < outer; o0 += kMaxGridY) {  // one grid for at most 65,535
    const long long n_outer = outer - o0 < kMaxGridY ? outer - o0 : kMaxGridY;
    mont_mul_bm_kernel<N16><<<dim3(blocks, static_cast<unsigned>(n_outer)), kRows, 0, stream>>>(
        static_cast<const int32_t*>(a) + o0 * sa.outer,
        static_cast<const int32_t*>(b) + o0 * sb.outer,
        static_cast<int32_t*>(out) + o0 * inner * N16, inner, sa, sb, m);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// a, b: int32 device rows of n16 contiguous limbs, row (o, i) of a at
// a + o*ao + i*ar (b likewise) for o < outer, i < inner; every row start
// 16-byte aligned.  out: contiguous (outer * inner, n16).  p_words: host
// array of n16/2 words of p; np0 = -p^-1 mod 2^32.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported limb count.
extern "C" int zk_mont_mul_bm(int n16, const void* a, const void* b, void* out,
                              long long outer, long long inner, long long ao, long long ar,
                              long long bo, long long br, const uint32_t* p_words,
                              uint32_t np0, void* stream) {
  if (outer * inner == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowStrides sa{ao, ar}, sb{bo, br};
  switch (n16) {
    case 16: return launch<16>(a, b, out, outer, inner, sa, sb, p_words, np0, s);
    case 24: return launch<24>(a, b, out, outer, inner, sa, sb, p_words, np0, s);
    case 48: return launch<48>(a, b, out, outer, inner, sa, sb, p_words, np0, s);
    default: return -1;
  }
}
