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

// ---------------------------------------------------------------------------
// Carry-chain arithmetic for the MSM finish (msm_finish.cu): PTX add.cc /
// madc chains in place of 64-bit emulated accumulators, on one lane (whole
// elements) or on a group of lanes (the split Montgomery product, gmul).
// Each instruction is its own volatile asm statement, so they keep their
// order and the carry flag passes from one to the next.
// ---------------------------------------------------------------------------

namespace cc {
#define ZK_CC_OP(name, ins)                                                       \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {             \
    uint32_t r;                                                                   \
    asm volatile(ins " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));                  \
    return r;                                                                     \
  }
ZK_CC_OP(add, "add.cc.u32")
ZK_CC_OP(addc, "addc.cc.u32")
ZK_CC_OP(addc_end, "addc.u32")
ZK_CC_OP(sub, "sub.cc.u32")
ZK_CC_OP(subc, "subc.cc.u32")
ZK_CC_OP(subc_end, "subc.u32")
#undef ZK_CC_OP
#define ZK_CC_MAD(name, ins)                                                      \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t r;                                                                   \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));      \
    return r;                                                                     \
  }
ZK_CC_MAD(mad_lo, "mad.lo.cc.u32")
ZK_CC_MAD(madc_lo, "madc.lo.cc.u32")
ZK_CC_MAD(mad_hi, "mad.hi.cc.u32")
ZK_CC_MAD(madc_hi, "madc.hi.cc.u32")
#undef ZK_CC_MAD
}  // namespace cc

// s = a + b over N words, no reduction (a + b < 2^(32N) by the caller).
template <int N>
__device__ __forceinline__ void add_words(Fe<N>& s, const Fe<N>& a, const Fe<N>& b) {
  s.w[0] = cc::add(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) s.w[i] = cc::addc(a.w[i], b.w[i]);
  s.w[N - 1] = cc::addc_end(a.w[N - 1], b.w[N - 1]);
}

// r = a + b mod p for a, b < p (a + b < 2p < 2^(32N): no carry out).
template <int N>
__device__ __forceinline__ void fadd_cc(Fe<N>& r, const Fe<N>& a, const Fe<N>& b,
                                        const Mod<N>& m) {
  Fe<N> s;
  uint32_t d[N];
  add_words<N>(s, a, b);
  d[0] = cc::sub(s.w[0], m.p[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = cc::subc(s.w[i], m.p[i]);
  const bool lt = cc::subc_end(0u, 0u) != 0u;  // a borrow: s < p
#pragma unroll
  for (int i = 0; i < N; ++i) r.w[i] = lt ? s.w[i] : d[i];
}

// r = a - b mod p for a, b < p.
template <int N>
__device__ __forceinline__ void fsub_cc(Fe<N>& r, const Fe<N>& a, const Fe<N>& b,
                                        const Mod<N>& m) {
  uint32_t d[N];
  d[0] = cc::sub(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) d[i] = cc::subc(a.w[i], b.w[i]);
  const uint32_t mask = cc::subc_end(0u, 0u);  // all ones on a borrow: add p back
  r.w[0] = cc::add(d[0], m.p[0] & mask);
#pragma unroll
  for (int i = 1; i < N - 1; ++i) r.w[i] = cc::addc(d[i], m.p[i] & mask);
  r.w[N - 1] = cc::addc_end(d[N - 1], m.p[N - 1] & mask);
}

// r = k x mod p for 0 <= k < 2^16: y = k x (N + 1 words), then y - q p
// with q from y's top 64 bits times magic = floor(2^64 / (p's top word
// + 1)), which is at most 2 below floor(y / p); two conditional
// subtractions finish.  Needs p's top word at least 2^20 (BLS12-381,
// BW6-761).
template <int N>
__device__ __forceinline__ void fmul_word(Fe<N>& r, const Fe<N>& x, uint32_t k, const Mod<N>& m,
                                          uint64_t magic) {
  uint32_t y[N + 1], lo[N];
#pragma unroll
  for (int i = 0; i < N; ++i) lo[i] = x.w[i] * k;
  y[0] = lo[0];
  y[1] = cc::mad_hi(x.w[0], k, lo[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) y[i] = cc::madc_hi(x.w[i - 1], k, lo[i]);
  y[N] = cc::madc_hi(x.w[N - 1], k, 0u);  // no carry out: k x < 2^(32N + 16)
  const uint64_t top = (static_cast<uint64_t>(y[N]) << 32) | y[N - 1];
  const uint32_t q = static_cast<uint32_t>(__umul64hi(top, magic));
  uint32_t qp[N + 1];
#pragma unroll
  for (int i = 0; i < N; ++i) lo[i] = m.p[i] * q;
  qp[0] = lo[0];
  qp[1] = cc::mad_hi(m.p[0], q, lo[1]);
#pragma unroll
  for (int i = 2; i < N; ++i) qp[i] = cc::madc_hi(m.p[i - 1], q, lo[i]);
  qp[N] = cc::madc_hi(m.p[N - 1], q, 0u);
  Fe<N> t;
  t.w[0] = cc::sub(y[0], qp[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) t.w[i] = cc::subc(y[i], qp[i]);  // y - q p < 3p < 2^(32N)
#pragma unroll
  for (int round = 0; round < 2; ++round) {
    uint32_t d[N];
    d[0] = cc::sub(t.w[0], m.p[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) d[i] = cc::subc(t.w[i], m.p[i]);
    const bool lt = cc::subc_end(0u, 0u) != 0u;
#pragma unroll
    for (int i = 0; i < N; ++i) t.w[i] = lt ? t.w[i] : d[i];
  }
  r = t;
}

// ---- lane groups: an element split over G = N / K lanes, K words a lane ----

// Every lane of a warp runs the same group operation at once, so shuffles
// and ballots take the whole warp's mask: a mask known only at run time
// made each of them about three times slower (measured in a clock64 chain
// on the H100).
constexpr unsigned kWarp = 0xFFFFFFFFu;

template <int N, int K>
struct Group {
  static_assert(N % K == 0 && 32 % (N / K) == 0, "a group is K words a lane");
  static constexpr int kN = N;
  static constexpr int kK = K;
  static constexpr int G = N / K;
  int j;      // the lane's place in its group: it holds words K j .. K j + K - 1
  int first;  // the warp lane of the group's j = 0

  __device__ static Group of(int lane) { return {lane % G, lane - lane % G}; }
};

// Words K j .. K j + K - 1 of a whole element, with j known only at run
// time: selects over compile-time indices, so `x` stays in registers.
template <int N, int K>
__device__ __forceinline__ void slice(uint32_t (&s)[K], const uint32_t (&x)[N], int j) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    uint32_t v = x[t];
#pragma unroll
    for (int jj = 1; jj < N / K; ++jj) v = j == jj ? x[K * jj + t] : v;
    s[t] = v;
  }
}

// Carries between the lanes of a group: each lane's generate (it carries
// out whatever comes in) and propagate (it carries out only if one comes
// in) bits, resolved as one addition of bit masks.  Returns the carry into
// this lane; `out` is the carry out of the group's top lane.
template <class Gr>
__device__ __forceinline__ uint32_t group_carry(const Gr& g, bool gen, bool prop, uint32_t& out) {
  if constexpr (Gr::G == 1) {
    out = gen ? 1u : 0u;
    return 0u;
  } else {
    constexpr unsigned kAll = (1u << Gr::G) - 1u;
    const unsigned gb = (__ballot_sync(kWarp, gen) >> g.first) & kAll;
    const unsigned pb = (__ballot_sync(kWarp, prop) >> g.first) & kAll;
    const unsigned c = ((gb | pb) + gb) ^ pb;  // bit x: the carry into lane x
    out = (c >> Gr::G) & 1u;
    return (c >> g.j) & 1u;
  }
}

// t += x y over a lane's K words, carries into t[K] and t[K + 1].
template <int K>
__device__ __forceinline__ void mac(uint32_t (&t)[K + 2], const uint32_t (&x)[K], uint32_t y) {
  t[0] = cc::mad_lo(x[0], y, t[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) t[i] = cc::madc_lo(x[i], y, t[i]);
  t[K] = cc::addc(t[K], 0u);
  t[K + 1] = cc::addc_end(t[K + 1], 0u);
  t[1] = cc::mad_hi(x[0], y, t[1]);
#pragma unroll
  for (int i = 1; i < K; ++i) t[i + 1] = cc::madc_hi(x[i], y, t[i + 1]);
  t[K + 1] = cc::addc_end(t[K + 1], 0u);
}

// Montgomery product a b 2^(-32N) mod p on a group of G = N / K lanes: lane
// j holds words K j .. K j + K - 1 of a (aj) and of p (pj), and all of b.
// CIOS by words of b: each lane adds its slice of a b_i and of q p, where q
// is lane 0's quotient word (one shuffle), then the accumulator moves down a
// word, lane j + 1's low word into lane j's top (one shuffle).  Each lane
// keeps the carries above its K words in two more words (they stay below
// 4), so no carry crosses a lane inside the loop; they are resolved once at
// the end, then p is subtracted if the result is not below it.  For
// a, b < 2p and 4p < 2^(32N) the result is the fully reduced a b 2^(-32N)
// mod p, whatever the split: the same limbs as fmul.  Every lane of the
// warp calls it at once.
template <class Gr>
__device__ __forceinline__ void gmul(uint32_t (&r)[Gr::kK], const uint32_t (&aj)[Gr::kK],
                                     const uint32_t (&b)[Gr::kN], const uint32_t (&pj)[Gr::kK],
                                     uint32_t np0, const Gr& g) {
  constexpr int N = Gr::kN, K = Gr::kK, G = Gr::G;
  uint32_t t[K + 2];
#pragma unroll
  for (int i = 0; i < K + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mac<K>(t, aj, b[i]);
    uint32_t q = t[0] * np0, down = 0u;
    if constexpr (G > 1) q = __shfl_sync(kWarp, q, 0, G);
    mac<K>(t, pj, q);
    if constexpr (G > 1) {
      down = __shfl_down_sync(kWarp, t[0], 1, G);
      if (g.j == G - 1) down = 0u;
    }
#pragma unroll
    for (int x = 0; x < K - 1; ++x) t[x] = t[x + 1];
    t[K - 1] = cc::add(t[K], down);
    t[K] = cc::addc_end(t[K + 1], 0u);
    t[K + 1] = 0u;
  }
  // lane j: t[0 .. K-1] + t[K] 2^(32K); t[K] goes to lane j + 1
  uint32_t up = 0u;
  if constexpr (G > 1) {
    up = __shfl_up_sync(kWarp, t[K], 1, G);
    if (g.j == 0) up = 0u;
  }
  t[0] = cc::add(t[0], up);
#pragma unroll
  for (int x = 1; x < K; ++x) t[x] = cc::addc(t[x], 0u);
  const uint32_t gen = cc::addc_end(0u, 0u);
  uint32_t all = t[0], top;
#pragma unroll
  for (int x = 1; x < K; ++x) all &= t[x];
  const uint32_t cin = group_carry(g, gen != 0u, all == 0xFFFFFFFFu, top);
  t[0] = cc::add(t[0], cin);
#pragma unroll
  for (int x = 1; x < K - 1; ++x) t[x] = cc::addc(t[x], 0u);
  t[K - 1] = cc::addc_end(t[K - 1], 0u);
  // the value is below 2p: subtract p unless it is below p
  uint32_t d[K];
  d[0] = cc::sub(t[0], pj[0]);
#pragma unroll
  for (int x = 1; x < K; ++x) d[x] = cc::subc(t[x], pj[x]);
  const uint32_t bw = cc::subc_end(0u, 0u);
  uint32_t any = d[0], below;
#pragma unroll
  for (int x = 1; x < K; ++x) any |= d[x];
  const uint32_t bin = group_carry(g, bw != 0u, any == 0u, below);
  d[0] = cc::sub(d[0], bin);
#pragma unroll
  for (int x = 1; x < K - 1; ++x) d[x] = cc::subc(d[x], 0u);
  d[K - 1] = cc::subc_end(d[K - 1], 0u);
#pragma unroll
  for (int x = 0; x < K; ++x) r[x] = below ? t[x] : d[x];
}

// ---- the finish's field types: whole elements on one lane, products split
// into base products that run on lane groups ----

template <int N>
struct FinishConsts {
  Mod<N> m;
  uint64_t magic;  // floor(2^64 / (p's top word + 1)), for fmul_word
  int b3c0, b3c1;  // b3 = b3c0 (+ b3c1 u over Fp2)
};

template <int N, int C>
struct FeC {
  Fe<N> c[C];
};

// C = 1: Fp.  C = 2: Fp2 with u^2 = -1, products as Karatsuba's three base
// products v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1).  Whole elements
// are added on one lane; the glue between product waves runs a component a
// lane (point.cuh: glue).
template <int N, int C>
struct FinishField {
  static_assert(C == 1 || C == 2, "Fp or Fp2");
  using E = FeC<N, C>;
  using Consts = FinishConsts<N>;
  static constexpr int kN = N;
  static constexpr int kC = C;
  static constexpr int kParts = C == 1 ? 1 : 3;

  __device__ static void add(E& r, const E& a, const E& b, const Consts& k) {
#pragma unroll
    for (int q = 0; q < C; ++q) fadd_cc<N>(r.c[q], a.c[q], b.c[q], k.m);
  }
  // The operands of base product `part` of a b (each below 2p).
  __device__ static void part_operands(Fe<N>& x, Fe<N>& y, const E& a, const E& b, int part) {
    if constexpr (C == 1) {
      x = a.c[0];
      y = b.c[0];
    } else {
      Fe<N> sa, sb;
      add_words<N>(sa, a.c[0], a.c[1]);
      add_words<N>(sb, b.c[0], b.c[1]);
#pragma unroll
      for (int i = 0; i < N; ++i) {  // picked by value: no runtime index into E
        x.w[i] = part == 2 ? sa.w[i] : part ? a.c[1].w[i] : a.c[0].w[i];
        y.w[i] = part == 2 ? sb.w[i] : part ? b.c[1].w[i] : b.c[0].w[i];
      }
    }
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
