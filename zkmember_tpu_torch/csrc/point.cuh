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
// exceptional cases, so doubling is addition).  Every field operation
// returns the fully reduced representative, so a result depends only on
// the order of the point additions, never on how one addition is
// scheduled: thread_add and warp_add give the same limbs.
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

// R = P + Q by one warp: each wave's 6 independent products, split into
// their kParts base products (6 or 18), run on separate lanes.  M: six
// slots; V: 6 kParts base-field slots.  Aliasing as for thread_add.  Every
// lane of the warp must call it.
template <class F>
__device__ void warp_add(const Slots<F>& R, const Slots<F>& P, const Slots<F>& Q,
                         const Slots<F>& M, const Slots<FpField<F::kN>>& V, int lane,
                         const typename F::Consts& c) {
  using E = typename F::E;
  constexpr int kP = F::kParts;
  E a, b, r;
  Fe<F::kN> v[kP];
  auto joined = [&](E& e, int k) {
#pragma unroll
    for (int p = 0; p < kP; ++p) V.ld(v[p], k * kP + p);
    F::join_parts(e, v, c);
  };
  // first wave: the six products of thread_add, raw
  if (lane < 6 * kP) {
    wave_a_operands<F, Slots<F>>(a, b, P, Q, lane / kP, c);
    F::mul_part(v[0], a, b, lane % kP, c);
    V.st(lane, v[0]);
  }
  __syncwarp();
  // M0 = 3 T0, M1 = T1 - b3 T2, M2 = T1 + b3 T2, M3 = T3 - T0 - T1,
  // M4 = T4 - T1 - T2, M5 = b3 (T5 - T0 - T2)
  if (lane < 6) {
    if (lane == 0) {
      joined(a, 0);
      F::mul3(r, a, c);
    } else if (lane < 3) {
      joined(a, 2);
      F::mulb3(a, a, c);
      joined(b, 1);
      if (lane == 1)
        F::sub(r, b, a, c);
      else
        F::add(r, b, a, c);
    } else {
      joined(r, lane);
      joined(a, pair_i(lane));
      F::sub(r, r, a, c);
      joined(a, pair_j(lane));
      F::sub(r, r, a, c);
      if (lane == 5) F::mulb3(r, r, c);
    }
    M.st(lane, r);
  }
  __syncwarp();
  // second wave: M3 M1, M4 M5, M5 M0, M1 M2, M2 M4, M0 M3
  if (lane < 6 * kP) {
    const int k = lane / kP;
    const int i = k == 0 ? 3 : k == 1 ? 4 : k == 2 ? 5 : k == 3 ? 1 : k == 4 ? 2 : 0;
    const int j = k == 0 ? 1 : k == 1 ? 5 : k == 2 ? 0 : k == 3 ? 2 : k == 4 ? 4 : 3;
    M.ld(a, i);
    M.ld(b, j);
    F::mul_part(v[0], a, b, lane % kP, c);
    V.st(lane, v[0]);
  }
  __syncwarp();
  // X3 = m0 - m1, Y3 = m2 + m3, Z3 = m4 + m5
  if (lane < 3) {
    joined(a, 2 * lane);
    joined(b, 2 * lane + 1);
    if (lane == 0)
      F::sub(r, a, b, c);
    else
      F::add(r, a, b, c);
    R.st(lane, r);
  }
  __syncwarp();
}

}  // namespace zk
