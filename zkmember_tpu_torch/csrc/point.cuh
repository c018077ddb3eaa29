// Complete projective point additions on points held in shared memory.
//
// A point of a short-Weierstrass a = 0 curve is (X, Y, Z) with coordinates
// in a field type of field.cuh (FpField or Fp2Field).  Its coordinates, and
// every intermediate of an addition, live in shared-memory "slots": an
// Fp2 point of BLS12-381 is 72 words, and two points plus the temporaries
// of an addition do not fit a thread's registers without spilling.  Only
// the operands of the field operation at hand are in registers.
//
// The addition is Renes-Costello-Batina 2015, Alg. 7 (12 products, no
// exceptional cases, so doubling is addition); the MSM finish's team
// operations below add the a = 0 doubling (Alg. 9).  Every field operation
// returns the fully reduced representative, so a result depends only on
// the order of the point operations, never on how one is scheduled.
#pragma once

#include "field.cuh"

namespace zk {

// Slot array: element s has component q's word i at
// base[((s * kComponents + q) * kN + i) * stride].  stride = threads of the
// block interleaves the threads' slots (a warp's access to one word falls
// in 32 banks); stride = 1 packs one warp's slots.
template <class F>
struct Slots {
  using E = typename F::E;
  static constexpr int kWords = F::kN * F::kComponents;  // words per element
  uint32_t* base;
  int stride;

  __device__ Slots at(int s) const { return {base + s * kWords * stride, stride}; }
  __device__ uint32_t& word(int s, int w) const { return base[(s * kWords + w) * stride]; }
  __device__ void ld(E& e, int s) const {
#pragma unroll
    for (int q = 0; q < F::kComponents; ++q)
#pragma unroll
      for (int i = 0; i < F::kN; ++i) F::comp(e, q).w[i] = word(s, q * F::kN + i);
  }
  __device__ void st(int s, const E& e) const {
#pragma unroll
    for (int q = 0; q < F::kComponents; ++q)
#pragma unroll
      for (int i = 0; i < F::kN; ++i) word(s, q * F::kN + i) = F::comp(e, q).w[i];
  }
};

// Point at `off` of a set of limb-major planes (one per coordinate
// component, 16-bit limbs in int32, limb stride `stride`) <-> slots 0..2.
template <class F>
__device__ __forceinline__ void ld_point(const Slots<F>& S, const int32_t* const* planes,
                                         long long off, long long stride) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < F::kComponents; ++q) {
      const int32_t* p = planes[c * F::kComponents + q] + off;
#pragma unroll
      for (int i = 0; i < F::kN; ++i) {
        const uint32_t lo = static_cast<uint32_t>(p[(2 * i) * stride]);
        const uint32_t hi = static_cast<uint32_t>(p[(2 * i + 1) * stride]);
        S.word(c, q * F::kN + i) = lo | (hi << 16);
      }
    }
}

// A point in global memory as one contiguous, 16-byte aligned record of
// 32-bit words in slot order (X, Y, Z; components; words), read in 16-byte
// loads.  It has the read interface of Slots, so an addition can take its
// second operand straight from the record.
template <class F>
struct Record {
  const uint32_t* p;

  __device__ void ld(typename F::E& e, int s) const {
    const uint4* v = reinterpret_cast<const uint4*>(p + s * Slots<F>::kWords);
#pragma unroll
    for (int k = 0; k < Slots<F>::kWords / 4; ++k) {
      const uint4 x = __ldg(v + k);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) F::comp(e, (4 * k + u) / F::kN).w[(4 * k + u) % F::kN] = w[u];
    }
  }
};

template <class F>
__device__ __forceinline__ void ld_record(const Slots<F>& S, const Record<F>& rec) {
  typename F::E e;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rec.ld(e, c);
    S.st(c, e);
  }
}

template <class F>
__device__ __forceinline__ void st_point(int32_t* const* planes, long long off, long long stride,
                                         const Slots<F>& S) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int q = 0; q < F::kComponents; ++q) {
      int32_t* p = planes[c * F::kComponents + q] + off;
#pragma unroll
      for (int i = 0; i < F::kN; ++i) {
        const uint32_t w = S.word(c, q * F::kN + i);
        p[(2 * i) * stride] = static_cast<int32_t>(w & 0xFFFFu);
        p[(2 * i + 1) * stride] = static_cast<int32_t>(w >> 16);
      }
    }
}

// Slot indices (i, j) of the coordinate pair of product k = 3, 4, 5 of the
// first wave: (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2).
__device__ __forceinline__ int pair_i(int k) { return k == 4 ? 1 : 0; }
__device__ __forceinline__ int pair_j(int k) { return k == 3 ? 1 : 2; }

// Operands of product k of the first wave.  Q: Slots or a Record.
template <class F, class QV>
__device__ __forceinline__ void wave_a_operands(typename F::E& a, typename F::E& b,
                                                const Slots<F>& P, const QV& Q, int k,
                                                const typename F::Consts& c) {
  if (k < 3) {
    P.ld(a, k);
    Q.ld(b, k);
  } else {
    typename F::E t;
    P.ld(a, pair_i(k));
    P.ld(t, pair_j(k));
    F::add(a, a, t, c);
    Q.ld(b, pair_i(k));
    Q.ld(t, pair_j(k));
    F::add(b, b, t, c);
  }
}

// R = P + Q by one thread.  P, Q, R: slots 0..2 hold X, Y, Z (Q may be a
// Record); T: six scratch slots.  R may alias P, and Q may alias P (a
// doubling).
// Inlined at every call: a call through the ABI keeps the caller's live
// values across it and spilled them in the tail kernel.
template <class F, class QV>
__device__ __forceinline__ void thread_add(const Slots<F>& R, const Slots<F>& P, const QV& Q,
                                           const Slots<F>& T, const typename F::Consts& c) {
  using E = typename F::E;
  // Products of 12-word elements (Fp at n = 24) go two at a time, so the
  // two carry chains overlap; an Fp2 product already holds three
  // independent base products, and a 24-word Fp product (n = 48) is long
  // enough alone and would not fit twice in a thread's registers.
  constexpr int kStep = Slots<F>::kWords <= 12 ? 2 : 1;
  E a, b, r;
  // T0..T2 = X1X2, Y1Y2, Z1Z2; T3 = X1Y2 + X2Y1, T4 = Y1Z2 + Y2Z1,
  // T5 = b3 (X1Z2 + X2Z1)
#pragma unroll 1
  for (int k = 0; k < 6; k += kStep) {
    E x[kStep], y[kStep], z[kStep];
#pragma unroll
    for (int u = 0; u < kStep; ++u) wave_a_operands<F, QV>(x[u], y[u], P, Q, k + u, c);
#pragma unroll
    for (int u = 0; u < kStep; ++u) F::mul(z[u], x[u], y[u], c);
#pragma unroll
    for (int u = 0; u < kStep; ++u) {
      if (k + u >= 3) {
        T.ld(a, pair_i(k + u));
        F::sub(z[u], z[u], a, c);
        T.ld(a, pair_j(k + u));
        F::sub(z[u], z[u], a, c);
        if (k + u == 5) F::mulb3(z[u], z[u], c);
      }
      T.st(k + u, z[u]);
    }
  }
  // T0 = 3 X1X2; with t = b3 Z1Z2: T2 = Y1Y2 + t, T1 = Y1Y2 - t
  T.ld(a, 0);
  F::mul3(a, a, c);
  T.st(0, a);
  T.ld(a, 2);
  F::mulb3(a, a, c);
  T.ld(b, 1);
  F::add(r, b, a, c);
  T.st(2, r);
  F::sub(r, b, a, c);
  T.st(1, r);
  // X3 = T3 T1 - T4 T5, Y3 = T5 T0 + T1 T2, Z3 = T2 T4 + T0 T3
  E s;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    const int i0 = k == 0 ? 3 : k == 1 ? 5 : 2, j0 = k == 0 ? 1 : k == 1 ? 0 : 4;
    const int i1 = k == 0 ? 4 : k == 1 ? 1 : 0, j1 = k == 0 ? 5 : k == 1 ? 2 : 3;
    T.ld(a, i0);
    T.ld(b, j0);
    F::mul(s, a, b, c);
    T.ld(a, i1);
    T.ld(b, j1);
    F::mul(r, a, b, c);
    if (k == 0)
      F::sub(r, s, r, c);
    else
      F::add(r, s, r, c);
    R.st(k, r);
  }
}

// ---------------------------------------------------------------------------
// The MSM finish's point operations (msm_finish.cu), run by a team of lane
// groups on points in shared memory: the complete addition (Alg. 7) and the
// a = 0 doubling (RCB15 Alg. 9, 8 products in two waves of 4, as
// curves/device.py::swp_double).  Each wave's base products run on the
// team's groups, one split Montgomery product a group at a time (gmul); the
// field operations between the waves ("glue") run on whole elements, one
// lane an output.  Every field operation returns the fully reduced
// representative, so the limbs equal those of the plain version's
// swp_add / swp_double on the same points.
// ---------------------------------------------------------------------------

// Elements of a FinishField in shared memory: element s, component q, word
// i at base[(s kC + q) kN + i]; 16-byte aligned, read and written whole.
template <class F>
struct Elems {
  uint32_t* base;

  __device__ uint32_t* at(int s, int q = 0) const { return base + (s * F::kC + q) * F::kN; }
  __device__ void ld(typename F::E& e, int s) const {
#pragma unroll
    for (int q = 0; q < F::kC; ++q) {
      const uint4* v = reinterpret_cast<const uint4*>(at(s, q));
#pragma unroll
      for (int k = 0; k < F::kN / 4; ++k) {
        const uint4 x = v[k];
        e.c[q].w[4 * k] = x.x;
        e.c[q].w[4 * k + 1] = x.y;
        e.c[q].w[4 * k + 2] = x.z;
        e.c[q].w[4 * k + 3] = x.w;
      }
    }
  }
  __device__ void st(int s, const typename F::E& e) const {
#pragma unroll
    for (int q = 0; q < F::kC; ++q) {
      uint4* v = reinterpret_cast<uint4*>(at(s, q));
#pragma unroll
      for (int k = 0; k < F::kN / 4; ++k)
        v[k] = make_uint4(e.c[q].w[4 * k], e.c[q].w[4 * k + 1], e.c[q].w[4 * k + 2],
                          e.c[q].w[4 * k + 3]);
    }
  }
};

template <class F>
using BaseOf = FinishField<F::kN, 1>;

// Who runs what in a point operation.  Whole warps run a wave's base
// products in lockstep: the warp's groups take products base + off, base +
// step + off, ... (a group past the last runs a product it does not keep).
// Glue output s of (kind, phase) runs on the lanes u = glue(kind, phase, s)
// >= 0, each a component (u % kC; lanes u >= kC repeat it and keep
// nothing).  sync() orders the waves.
// The join's warp for glue output s of (kind, phase), for its 6 warps:
// warps w and w + 4 share a scheduler, and a glue output all but fills a
// scheduler's issue, so each scheduler gets one costly output or a costly
// and a cheap one (in a clock64 chain on the H100, 6 outputs on 6 warps in
// turn took 3 times one output).
__host__ __device__ constexpr int glue_warp(int kind, int phase, int s) {
  // addition: M0 3 T0, M1 T1 - b3 T2, M2 T1 + b3 T2, M3, M4 two subtractions,
  // M5 b3 (T5 - T0 - T2); doubling: M0 b3 T2, M1 8 T0, M2 copy, M3
  // T0 - 3 b3 T2, M4 T0 + b3 T2, M5 copy
  // warps of M0 .. M5 as nibbles: addition 1, 2, 0, 4, 5, 3; doubling 0, 1, 4, 2, 3, 5
  return phase ? s : ((kind == 0 ? 0x354021 : 0x532410) >> (4 * s)) & 15;
}

struct BlockTeam {  // every warp of the block (the join): a glue output a warp
  int base, off, step, warp, lane;
  __device__ int glue(int kind, int phase, int s) const {
    return warp == glue_warp(kind, phase, s) ? lane : -1;
  }
  __device__ void sync() const { __syncthreads(); }
};

struct GroupTeam {  // each group alone (the tail): every output in turn
  static constexpr int base = 0, off = 0, step = 1;
  int j;
  __device__ int glue(int, int, int) const { return j; }
  __device__ void sync() const { __syncwarp(); }
};

enum { kAdd = 0, kDbl = 1 };

// Nibble s of a packed table (0xF: none).
__device__ __forceinline__ int nib(uint32_t t, int s) {
  const int v = (t >> (4 * s)) & 0xF;
  return v == 0xF ? -1 : v;
}
__host__ __device__ constexpr uint32_t pack(int a, int b, int c, int d, int e = 15, int f = 15) {
  return a | b << 4 | c << 8 | d << 12 | e << 16 | f << 20;
}

// The operands of product s of a wave: a = A[ai] (+ A[aj]), b = B[bi]
// (+ B[bj]), where A, B are P and Q (addition, first wave), P (doubling,
// first wave) or M (second waves).
//   addition:  X1X2, Y1Y2, Z1Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2),
//              (X1 + Z1)(X2 + Z2); then M3 M1, M4 M5, M5 M0, M1 M2, M2 M4, M0 M3
//   doubling:  Y^2, Y Z, Z^2, X Y; then M0 M1, M2 M1, M3 M4, M3 M5
struct ProductSpec {
  int ai, aj, bi, bj;
};
__device__ __forceinline__ ProductSpec product_spec(int kind, int phase, int s) {
  uint32_t ai, aj, bi, bj;
  if (kind == kAdd && phase == 0) {
    ai = bi = pack(0, 1, 2, 0, 1, 0);
    aj = bj = pack(15, 15, 15, 1, 2, 2);
  } else if (kind == kAdd) {
    ai = pack(3, 4, 5, 1, 2, 0);
    bi = pack(1, 5, 0, 2, 4, 3);
    aj = bj = ~0u;
  } else if (phase == 0) {
    ai = pack(1, 1, 2, 0);
    bi = pack(1, 2, 2, 1);
    aj = bj = ~0u;
  } else {
    ai = pack(0, 2, 3, 3);
    bi = pack(1, 1, 4, 5);
    aj = bj = ~0u;
  }
  return {nib(ai, s), nib(aj, s), nib(bi, s), nib(bj, s)};
}

// Glue output s: c (T[x] + cy T[y] + cz T[z]), T[i] product i of the wave
// before it; cy is m or m b3, cz is +1 or -1, c is m or b3.
//   addition:  M0 = 3 T0, M1 = T1 - b3 T2, M2 = T1 + b3 T2, M3 = T3 - T0 - T1,
//              M4 = T4 - T1 - T2, M5 = b3 (T5 - T0 - T2);
//              X3 = T0 - T1, Y3 = T2 + T3, Z3 = T4 + T5
//   doubling:  M0 = b3 T2, M1 = 8 T0, M2 = T1, M3 = T0 - 3 b3 T2,
//              M4 = T0 + b3 T2, M5 = T3;  X3 = 2 T3, Y3 = T0 + T2, Z3 = T1
// Each output is one word: x (bits 0-3), y (4-7), z (8-11; 15: none), cy's
// m + 8 (12-15) and b3 flag (16), cz < 0 (17), c's m (20-27) and b3 flag
// (28).
struct Coef {
  int m;
  bool b3;
};
__host__ __device__ constexpr uint32_t glue_code(int x, int y = 15, int ym = 1, bool yb3 = false,
                                                 int z = 15, bool zneg = false, int cm = 1,
                                                 bool cb3 = false) {
  return x | y << 4 | z << 8 | (ym + 8) << 12 | (yb3 ? 1u : 0u) << 16 |
         (zneg ? 1u : 0u) << 17 | cm << 20 | (cb3 ? 1u : 0u) << 28;
}
// [kind][phase][s]
constexpr uint32_t kGlueCodes[2][2][6] = {
    {{glue_code(0, 15, 1, false, 15, false, 3), glue_code(1, 2, -1, true),
      glue_code(1, 2, 1, true), glue_code(3, 0, -1, false, 1, true),
      glue_code(4, 1, -1, false, 2, true), glue_code(5, 0, -1, false, 2, true, 1, true)},
     {glue_code(0, 1, -1), glue_code(2, 3), glue_code(4, 5), 0, 0, 0}},
    {{glue_code(2, 15, 1, false, 15, false, 1, true), glue_code(0, 15, 1, false, 15, false, 8),
      glue_code(1), glue_code(0, 2, -3, true), glue_code(0, 2, 1, true), glue_code(3)},
     {glue_code(3, 15, 1, false, 15, false, 2), glue_code(0, 2), glue_code(1), 0, 0, 0}},
};

// Component q of product s from its base products in V: Fp: v0; Fp2:
// c0 = v0 - v1, c1 = v2 - v0 - v1.
template <class F>
__device__ __forceinline__ void joined(Fe<F::kN>& r, const Elems<BaseOf<F>>& V, int s, int q,
                                       const typename F::Consts& k) {
  typename BaseOf<F>::E v0, v1, v2;
  V.ld(v0, s * F::kParts);
  if constexpr (F::kC == 1) {
    r = v0.c[0];
  } else {
    V.ld(v1, s * F::kParts + 1);
    V.ld(v2, s * F::kParts + 2);
    Fe<F::kN> d;
    fsub_cc<F::kN>(d, v2.c[0], v0.c[0], k.m);
#pragma unroll
    for (int i = 0; i < F::kN; ++i) d.w[i] = q ? d.w[i] : v0.c[0].w[i];
    fsub_cc<F::kN>(r, d, v1.c[0], k.m);
  }
}

// Component q of c v for a coefficient c = c0 + c1 u with c1 = 0 or c1 = c0
// (the b3 of every curve here; the launch refuses others); v's other
// component comes from the neighbouring lane (every lane of the warp calls
// it).  Returns |c0| v (c1 = 0) or |c0| (v0 -+ v1) (c1 = c0) and sets `neg`
// where the caller must subtract it instead of adding.
template <class F>
__device__ __forceinline__ void coef_mul(Fe<F::kN>& v, Coef c, int q, bool& neg,
                                         const typename F::Consts& k) {
  constexpr int N = F::kN;
  const int c0 = c.b3 ? c.m * k.b3c0 : c.m;
  const uint32_t a0 = static_cast<uint32_t>(c0 < 0 ? -c0 : c0);
  neg = c0 < 0;
  if constexpr (F::kC == 2) {
    if (c.b3 && k.b3c1 != 0) {  // c0 (v0 - v1) + c0 (v0 + v1) u
      Fe<N> o, s, d;
#pragma unroll
      for (int i = 0; i < N; ++i) o.w[i] = __shfl_xor_sync(kWarp, v.w[i], 1);
      fadd_cc<N>(s, v, o, k.m);
      fsub_cc<N>(d, v, o, k.m);
#pragma unroll
      for (int i = 0; i < N; ++i) v.w[i] = q ? s.w[i] : d.w[i];
    }
  }
  if (a0 == 2)
    fadd_cc<N>(v, v, v, k.m);
  else if (a0 != 1)
    fmul_word<N>(v, v, a0, k.m, k.magic);
}

// Glue output kCode, component u % kC of it, into dst (a whole element's
// slot) when u < kC.  Every lane of the warp calls it.  One instance an
// output, picked by one branch (glue_output): with the code a run-time value
// the compiler predicated every output's path and each warp ran them all.
template <class F, uint32_t kCode>
__device__ __forceinline__ void glue(uint32_t* dst, const Elems<BaseOf<F>>& V, int u,
                                     const typename F::Consts& k) {
  constexpr int N = F::kN;
  constexpr int x = kCode & 15, y = (kCode >> 4) & 15, z = (kCode >> 8) & 15;
  constexpr Coef cy{static_cast<int>((kCode >> 12) & 15) - 8, ((kCode >> 16) & 1) != 0};
  constexpr Coef c{static_cast<int>((kCode >> 20) & 255), ((kCode >> 28) & 1) != 0};
  const int q = u % F::kC;
  Fe<N> acc, v;
  bool neg = false;
  joined<F>(acc, V, x, q, k);
  if constexpr (y != 15) {
    joined<F>(v, V, y, q, k);
    neg = cy.m < 0 && !cy.b3;
    if constexpr (cy.b3 || (cy.m != 1 && cy.m != -1)) coef_mul<F>(v, cy, q, neg, k);
    if (neg)
      fsub_cc<N>(acc, acc, v, k.m);
    else
      fadd_cc<N>(acc, acc, v, k.m);
  }
  if constexpr (z != 15) {
    joined<F>(v, V, z, q, k);
    if constexpr (((kCode >> 17) & 1) != 0)
      fsub_cc<N>(acc, acc, v, k.m);
    else
      fadd_cc<N>(acc, acc, v, k.m);
  }
  if constexpr (c.b3 || c.m != 1) {
    neg = false;
    coef_mul<F>(acc, c, q, neg, k);
    if (neg) {
      fzero<N>(v);
      fsub_cc<N>(acc, v, acc, k.m);
    }
  }
  if (u >= F::kC) return;
  uint4* o = reinterpret_cast<uint4*>(dst + q * N);
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    o[i] = make_uint4(acc.w[4 * i], acc.w[4 * i + 1], acc.w[4 * i + 2], acc.w[4 * i + 3]);
}

template <class F>
__device__ __forceinline__ void glue_output(int kind, int phase, int s, uint32_t* dst,
                                            const Elems<BaseOf<F>>& V, int u,
                                            const typename F::Consts& k) {
#define ZK_GLUE(KIND, PHASE, S)                                        \
  case (KIND * 2 + PHASE) * 6 + S:                                     \
    glue<F, kGlueCodes[KIND][PHASE][S]>(dst, V, u, k);                  \
    break;
  switch ((kind * 2 + phase) * 6 + s) {
    ZK_GLUE(0, 0, 0) ZK_GLUE(0, 0, 1) ZK_GLUE(0, 0, 2) ZK_GLUE(0, 0, 3) ZK_GLUE(0, 0, 4)
    ZK_GLUE(0, 0, 5) ZK_GLUE(0, 1, 0) ZK_GLUE(0, 1, 1) ZK_GLUE(0, 1, 2)
    ZK_GLUE(1, 0, 0) ZK_GLUE(1, 0, 1) ZK_GLUE(1, 0, 2) ZK_GLUE(1, 0, 3) ZK_GLUE(1, 0, 4)
    ZK_GLUE(1, 0, 5) ZK_GLUE(1, 1, 0) ZK_GLUE(1, 1, 1) ZK_GLUE(1, 1, 2)
    default: break;
  }
#undef ZK_GLUE
}

// Phase `phase` of a point operation of kind `kind`: its wave of products
// into V.  A, B: the slots its operands come from (P and Q, or P, in the
// first phase; M in the second).
template <class F, class Team, class Gr>
__device__ __forceinline__ void team_wave(const Team& tm, const Gr& g, int kind, int phase,
                                          const Elems<F>& A, const Elems<F>& B,
                                          const Elems<BaseOf<F>>& V,
                                          const uint32_t (&pj)[Gr::kK],
                                          const typename F::Consts& k) {
  using E = typename F::E;
  constexpr int K = Gr::kK;
  const int n = (kind == kAdd ? 6 : 4) * F::kParts;
  for (int t0 = tm.base; t0 < n; t0 += tm.step) {
    const int t = t0 + tm.off < n ? t0 + tm.off : n - 1;
    const ProductSpec sp = product_spec(kind, phase, t / F::kParts);
    E a, b, u;
    A.ld(a, sp.ai);
    if (sp.aj >= 0) {
      A.ld(u, sp.aj);
      F::add(a, a, u, k);
    }
    B.ld(b, sp.bi);
    if (sp.bj >= 0) {
      B.ld(u, sp.bj);
      F::add(b, b, u, k);
    }
    Fe<F::kN> x, y;
    F::part_operands(x, y, a, b, t % F::kParts);
    uint32_t xj[K], r[K];
    slice<F::kN, K>(xj, x.w, g.j);
    gmul(r, xj, y.w, pj, k.m.np0, g);
    if (t0 + tm.off < n) {
      uint32_t* o = V.at(t) + K * g.j;
#pragma unroll
      for (int i = 0; i < K; ++i) o[i] = r[i];
    }
  }
}

// The glue after the wave of phase `phase`: its outputs into D (M after
// the first wave, R after the second).
template <class F, class Team>
__device__ __forceinline__ void team_glue(const Team& tm, int kind, int phase,
                                          const Elems<F>& D, const Elems<BaseOf<F>>& V,
                                          const typename F::Consts& k) {
  const int nout = phase ? 3 : 6;
#pragma unroll 1
  for (int s = 0; s < nout; ++s) {
    const int u = tm.glue(kind, phase, s);
    if (u >= 0) glue_output<F>(kind, phase, s, D.at(s), V, u, k);
  }
}

// One point operation, kind kAdd (R = P + Q, RCB15 Alg. 7) or kDbl (R =
// 2 P, Alg. 9, a = 0), in two phases of a wave of products and its glue.
// M: six element slots (may overlay P and Q: both are read by the first
// wave only); V: 6 kParts base slots; R may be P.
template <class F, class Team, class Gr>
__device__ void team_op(const Team& tm, const Gr& g, int kind, const Elems<F>& R,
                        const Elems<F>& P, const Elems<F>& Q, const Elems<F>& M,
                        const Elems<BaseOf<F>>& V, const uint32_t (&pj)[Gr::kK],
                        const typename F::Consts& k) {
#pragma unroll 1
  for (int phase = 0; phase < 2; ++phase) {
    team_wave<F>(tm, g, kind, phase, phase ? M : P, phase ? M : kind == kAdd ? Q : P, V, pj, k);
    tm.sync();
    team_glue<F>(tm, kind, phase, phase ? R : M, V, k);
    tm.sync();
  }
}

}  // namespace zk
