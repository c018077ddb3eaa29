// K3: elementwise Montgomery product on batch-major rows.
//
// Replaces the Pallas kernel zkmember_tpu/fields/pallas_field.py::mont_mul
// (_mont_mul_pallas_2d, kernel _kernel): out = a * b * R^-1 mod p, fully
// reduced, over (rows, n) int32 rows of 16-bit limbs, n in {16, 24, 48}.
//
// Design: one thread per row, CIOS over n/2 packed 32-bit words with 64-bit
// accumulators (zk::fmul, the routine K2 runs).  The TPU kernel's MXU column
// routing, shift-accumulate mode and Kogge-Stone carries were shaped by a
// vector unit without wide multiplies and do not carry over.  What is new
// against K2 is the layout: a row's n limbs are contiguous, so a thread that
// read its own row would make every warp load touch 32 rows n words apart.
// Instead a block stages its ROWS consecutive rows -- one contiguous segment
// of ROWS * n words -- through shared memory with coalesced loads, each
// thread packs its row from there, and the results go back the same way.
// Shared rows are padded to n + 1 words (an odd stride), so the threads of a
// warp reading limb i of their rows hit 32 different banks.
//
// Bound: bytes.  Per row the kernel moves 3 x n limbs x 4 B (two inputs,
// one output: 288 B at n = 24, 192 B at n = 16) and issues 2 (n/2)^2 full
// 32x32->64 multiplies (two IMADs each) and n/2 low-word ones: 588 IMADs at
// n = 24.  At the H100's 3.35 TB/s and 16.75e12 IMAD/s the bytes take longer.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

// Rows per block: 128 for n <= 24 (2 x 128 x 25 x 4 B = 25 KB of shared
// memory at n = 24), 64 at n = 48 (25 KB) -- both under the 48 KB of
// static shared memory.
template <int N16>
struct Tile {
  static constexpr int kRows = N16 <= 24 ? 128 : 64;
  static constexpr int kStride = N16 + 1;
};

template <int N16>
__global__ void __launch_bounds__(Tile<N16>::kRows)
mont_mul_bm_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, long long rows, zk::Mod<N16 / 2> m) {
  constexpr int R = Tile<N16>::kRows;
  constexpr int S = Tile<N16>::kStride;
  constexpr int N = N16 / 2;
  __shared__ int32_t sa[R * S];
  __shared__ int32_t sb[R * S];

  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int here = static_cast<int>(rows - r0 < R ? rows - r0 : R);
  const long long base = r0 * N16;
  const int count = here * N16;

  for (int i = threadIdx.x; i < count; i += R) {  // coalesced: consecutive words
    const int row = i / N16;
    const int col = i - row * N16;
    sa[row * S + col] = a[base + i];
    sb[row * S + col] = b[base + i];
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < here) {
    zk::Fe<N> x, y, r;
    zk::load_fe<N>(x, sa + t * S, 1);
    zk::load_fe<N>(y, sb + t * S, 1);
    zk::fmul<N>(r, x, y, m);
    zk::store_fe<N>(r, sa + t * S, 1);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < count; i += R) {
    const int row = i / N16;
    const int col = i - row * N16;
    out[base + i] = sa[row * S + col];
  }
}

template <int N16>
int launch(const void* a, const void* b, void* out, long long rows, const uint32_t* p_words,
           uint32_t np0, cudaStream_t stream) {
  zk::Mod<N16 / 2> m;
  for (int i = 0; i < N16 / 2; ++i) m.p[i] = p_words[i];
  m.np0 = np0;
  constexpr int R = Tile<N16>::kRows;
  const unsigned blocks = static_cast<unsigned>((rows + R - 1) / R);
  mont_mul_bm_kernel<N16><<<blocks, R, 0, stream>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), rows, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, out: contiguous (rows, n16) int32 device rows.  p_words: host array
// of n16/2 words of p; np0 = -p^-1 mod 2^32.  Returns cudaGetLastError()
// after the launch, or -1 for an unsupported limb count.
extern "C" int zk_mont_mul_bm(int n16, const void* a, const void* b, void* out,
                              long long rows, const uint32_t* p_words, uint32_t np0,
                              void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n16) {
    case 16: return launch<16>(a, b, out, rows, p_words, np0, s);
    case 24: return launch<24>(a, b, out, rows, p_words, np0, s);
    case 48: return launch<48>(a, b, out, rows, p_words, np0, s);
    default: return -1;
  }
}
