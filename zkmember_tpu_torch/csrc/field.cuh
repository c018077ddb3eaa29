// Prime-field and curve arithmetic for the hand-written Hopper kernels.
//
// Public planes are limb-major (..., n, B) int32 arrays of 16-bit limbs in
// Montgomery form with R = 2^(16 n).  Inside a thread an element is packed
// into N = n/2 little-endian 32-bit words: R = 2^(32 N) is the same number,
// so Montgomery forms agree bit for bit with the reference planes.  The
// word-level Montgomery constant is np0 = -p^-1 mod 2^32.
//
// Every operation returns the fully reduced representative in [0, p), so a
// result is unique and equals the reference's whatever order of carries or
// products produced it.
#pragma once

#include <cstdint>

namespace zk {

template <int N>
struct Mod {
  uint32_t p[N];
  uint32_t np0;
};

template <int N>
struct Fe {
  uint32_t w[N];
};

// Element at `base` whose limb i sits at base[i * stride].
template <int N>
__device__ __forceinline__ void load_fe(Fe<N>& x, const int32_t* base, long long stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t lo = static_cast<uint32_t>(base[(2 * i) * stride]);
    uint32_t hi = static_cast<uint32_t>(base[(2 * i + 1) * stride]);
    x.w[i] = lo | (hi << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_fe(const Fe<N>& x, int32_t* base, long long stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    base[(2 * i) * stride] = static_cast<int32_t>(x.w[i] & 0xFFFFu);
    base[(2 * i + 1) * stride] = static_cast<int32_t>(x.w[i] >> 16);
  }
}

// r = s - p if (carry or s >= p) else s, for s + carry * 2^(32N) < 2p.
template <int N>
__device__ __forceinline__ void reduce_once(Fe<N>& r, const uint32_t* s, uint32_t carry,
                                            const Mod<N>& m) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t t = static_cast<uint64_t>(s[i]) - m.p[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  const bool ge = carry != 0 || borrow == 0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.w[i] = ge ? d[i] : s[i];
}

template <int N>
__device__ __forceinline__ void fadd(Fe<N>& r, const Fe<N>& a, const Fe<N>& b, const Mod<N>& m) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += static_cast<uint64_t>(a.w[i]) + b.w[i];
    s[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  reduce_once<N>(r, s, static_cast<uint32_t>(c), m);
}

template <int N>
__device__ __forceinline__ void fsub(Fe<N>& r, const Fe<N>& a, const Fe<N>& b, const Mod<N>& m) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t t = static_cast<uint64_t>(a.w[i]) - b.w[i] - borrow;
    d[i] = static_cast<uint32_t>(t);
    borrow = (t >> 32) & 1u;
  }
  const uint32_t mask = 0u - static_cast<uint32_t>(borrow);  // add p back on borrow
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += static_cast<uint64_t>(d[i]) + (m.p[i] & mask);
    r.w[i] = static_cast<uint32_t>(c);
    c >>= 32;
  }
}

// Montgomery product a * b * 2^(-32N) mod p: CIOS over 32-bit words with
// 64-bit accumulators ((2^32-1)^2 + 2 (2^32-1) = 2^64 - 1 never overflows).
template <int N>
__device__ __forceinline__ void fmul(Fe<N>& r, const Fe<N>& a, const Fe<N>& b, const Mod<N>& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t uv = static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j] + carry;
      t[j] = static_cast<uint32_t>(uv);
      carry = uv >> 32;
    }
    uint64_t uv = static_cast<uint64_t>(t[N]) + carry;
    t[N] = static_cast<uint32_t>(uv);
    t[N + 1] = static_cast<uint32_t>(uv >> 32);
    const uint32_t mm = t[0] * m.np0;
    uv = static_cast<uint64_t>(mm) * m.p[0] + t[0];
    carry = uv >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      uv = static_cast<uint64_t>(mm) * m.p[j] + t[j] + carry;
      t[j - 1] = static_cast<uint32_t>(uv);
      carry = uv >> 32;
    }
    uv = static_cast<uint64_t>(t[N]) + carry;
    t[N - 1] = static_cast<uint32_t>(uv);
    t[N] = t[N + 1] + static_cast<uint32_t>(uv >> 32);
  }
  reduce_once<N>(r, t, t[N], m);
}

template <int N>
__device__ __forceinline__ void fzero(Fe<N>& r) {
#pragma unroll
  for (int i = 0; i < N; ++i) r.w[i] = 0;
}

// r = k * x for a small signed k: double-and-add from the top bit down
// (2 additions for k = 3, 4 for k = 12).
template <int N>
__device__ __forceinline__ void fmul_small(Fe<N>& r, const Fe<N>& x, int k, const Mod<N>& m) {
  const bool neg = k < 0;
  const unsigned u = neg ? static_cast<unsigned>(-k) : static_cast<unsigned>(k);
  Fe<N> acc;
  fzero<N>(acc);
  if (u) {
    acc = x;
    for (int bit = 30 - __clz(u); bit >= 0; --bit) {
      fadd<N>(acc, acc, acc, m);
      if ((u >> bit) & 1u) fadd<N>(acc, acc, x, m);
    }
  }
  if (neg) {
    Fe<N> z;
    fzero<N>(z);
    fsub<N>(acc, z, acc, m);
  }
  r = acc;
}

// ---------------------------------------------------------------------------
// Base field and its quadratic extension u^2 = -1 as interchangeable types.
// ---------------------------------------------------------------------------

template <int N>
struct FpField {
  using E = Fe<N>;
  static constexpr int kN = N;
  static constexpr int kComponents = 1;
  static constexpr int kParts = 1;  // base products of one product
  struct Consts {
    Mod<N> m;
    int b3;
  };
  __device__ static void add(E& r, const E& a, const E& b, const Consts& c) { fadd<N>(r, a, b, c.m); }
  __device__ static void sub(E& r, const E& a, const E& b, const Consts& c) { fsub<N>(r, a, b, c.m); }
  __device__ static void mul(E& r, const E& a, const E& b, const Consts& c) { fmul<N>(r, a, b, c.m); }
  __device__ static void mul3(E& r, const E& a, const Consts& c) { fmul_small<N>(r, a, 3, c.m); }
  __device__ static void mulb3(E& r, const E& a, const Consts& c) { fmul_small<N>(r, a, c.b3, c.m); }
  __device__ static Fe<N>& comp(E& e, int) { return e; }
  __device__ static const Fe<N>& comp(const E& e, int) { return e; }
  // A product split into base products that run apart (one part for Fp).
  __device__ static void mul_part(Fe<N>& v, const E& a, const E& b, int, const Consts& c) {
    fmul<N>(v, a, b, c.m);
  }
  __device__ static void join_parts(E& r, const Fe<N>* v, const Consts&) { r = v[0]; }
};

template <int N>
struct Fp2 {
  Fe<N> c0, c1;
};

// Fq2 with u^2 = -1 (BLS12-381 G2); b3 = b3c0 + b3c1 u.
template <int N>
struct Fp2Field {
  using E = Fp2<N>;
  static constexpr int kN = N;
  static constexpr int kComponents = 2;
  static constexpr int kParts = 3;
  struct Consts {
    Mod<N> m;
    int b3c0, b3c1;
  };
  __device__ static void add(E& r, const E& a, const E& b, const Consts& c) {
    fadd<N>(r.c0, a.c0, b.c0, c.m);
    fadd<N>(r.c1, a.c1, b.c1, c.m);
  }
  __device__ static void sub(E& r, const E& a, const E& b, const Consts& c) {
    fsub<N>(r.c0, a.c0, b.c0, c.m);
    fsub<N>(r.c1, a.c1, b.c1, c.m);
  }
  // Karatsuba: 3 base products; c0 = v0 - v1, c1 = (a0+a1)(b0+b1) - v0 - v1.
  __device__ static void mul(E& r, const E& a, const E& b, const Consts& c) {
    Fe<N> v0, v1, sa, sb, t;
    fmul<N>(v0, a.c0, b.c0, c.m);
    fmul<N>(v1, a.c1, b.c1, c.m);
    fadd<N>(sa, a.c0, a.c1, c.m);
    fadd<N>(sb, b.c0, b.c1, c.m);
    fmul<N>(t, sa, sb, c.m);
    fsub<N>(r.c0, v0, v1, c.m);
    fsub<N>(t, t, v0, c.m);
    fsub<N>(r.c1, t, v1, c.m);
  }
  __device__ static void mul3(E& r, const E& a, const Consts& c) {
    fmul_small<N>(r.c0, a.c0, 3, c.m);
    fmul_small<N>(r.c1, a.c1, 3, c.m);
  }
  // (b3c0 + b3c1 u)(a0 + a1 u) = (b3c0 a0 - b3c1 a1) + (b3c0 a1 + b3c1 a0) u
  __device__ static void mulb3(E& r, const E& a, const Consts& c) {
    Fe<N> x0, x1, y0, y1;
    fmul_small<N>(x0, a.c0, c.b3c0, c.m);
    fmul_small<N>(x1, a.c1, c.b3c1, c.m);
    fmul_small<N>(y0, a.c1, c.b3c0, c.m);
    fmul_small<N>(y1, a.c0, c.b3c1, c.m);
    fsub<N>(r.c0, x0, x1, c.m);
    fadd<N>(r.c1, y0, y1, c.m);
  }
  __device__ static Fe<N>& comp(E& e, int i) { return i == 0 ? e.c0 : e.c1; }
  __device__ static const Fe<N>& comp(const E& e, int i) { return i == 0 ? e.c0 : e.c1; }
  // The Karatsuba products of mul apart: v0 = a0 b0, v1 = a1 b1,
  // v2 = (a0 + a1)(b0 + b1); join_parts gives mul's result from them.
  // `part` may differ between threads: operands are picked by value, so no
  // component is addressed by a runtime index (which would move it to
  // local memory).
  __device__ static void mul_part(Fe<N>& v, const E& a, const E& b, int part, const Consts& c) {
    Fe<N> x, y;
    if (part == 2) {
      fadd<N>(x, a.c0, a.c1, c.m);
      fadd<N>(y, b.c0, b.c1, c.m);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x.w[i] = part ? a.c1.w[i] : a.c0.w[i];
        y.w[i] = part ? b.c1.w[i] : b.c0.w[i];
      }
    }
    fmul<N>(v, x, y, c.m);
  }
  __device__ static void join_parts(E& r, const Fe<N>* v, const Consts& c) {
    Fe<N> t;
    fsub<N>(t, v[2], v[0], c.m);
    fsub<N>(r.c1, t, v[1], c.m);
    fsub<N>(r.c0, v[0], v[1], c.m);
  }
};

// A field type's launch constants from host data: p's N words, np0 and
// b3 = b3c0 (+ b3c1 u for Fp2), signed.
template <class F>
typename F::Consts make_consts(const uint32_t* p_words, uint32_t np0, int b3c0, int b3c1) {
  typename F::Consts c;
  for (int i = 0; i < F::kN; ++i) c.m.p[i] = p_words[i];
  c.m.np0 = np0;
  if constexpr (F::kComponents == 2) {
    c.b3c0 = b3c0;
    c.b3c1 = b3c1;
  } else {
    c.b3 = b3c0;
  }
  return c;
}

}  // namespace zk
