// Montgomery arithmetic over the BLS12-381 fields for one element per
// thread: little-endian 32-bit words, R = 2^(32 N) (2^256 for Fr, 2^384
// for Fp), values canonical in [0, q) on entry and on exit.  This is the
// same representation as the reference's 16-bit limbs, packed two limbs
// per word, so results compare bit for bit.
//
// Every sum runs through the carry flag (ptx.cuh): an N-word add, a
// subtract or one row of a product is one chain of N 32-bit
// instructions, with no 64-bit emulation and no carries kept in
// registers.  The multiply is word-serial Montgomery (CIOS) on two
// accumulators, the layout of sppark's mont_t: the products of a's even
// words with b_i do not overlap each other (lo at word j, hi at j + 1),
// nor do those of its odd words, so each row is two carry chains of
// mad.lo/madc.hi into the "even" (weight 1) and "odd" (weight 2^32)
// accumulators.  The shift by one word after each reduction swaps their
// roles and folds into the next row's odd chain (madc_n_rshift).  Both
// moduli leave a spare top bit (2q < 2^(32N)), so the running value stays
// below 2q and one conditional subtract makes it canonical.
#pragma once
#include <stdint.h>
#include "ptx.cuh"

struct FrParams {
  static constexpr int N = 8;
  __device__ static __forceinline__ uint32_t q(int i) {
    const uint32_t Q[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                           0x53bda402u, 0x09a1d805u, 0x3339d808u,
                           0x299d7d48u, 0x73eda753u};
    return Q[i];
  }
  static constexpr uint32_t NINV0 = 0xffffffffu;  // -q^-1 mod 2^32
};

struct FpParams {
  static constexpr int N = 12;
  __device__ static __forceinline__ uint32_t q(int i) {
    const uint32_t Q[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu,
                            0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                            0xf38512bfu, 0x64774b84u, 0x434bacd7u,
                            0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return Q[i];
  }
  static constexpr uint32_t NINV0 = 0xfffcfffdu;
};

// Operands and the sum are reached through pointers of any qualification
// (A, B, R): the G1 walk passes `volatile` pointers into shared memory,
// so that each word is loaded or stored where it is used instead of held
// in a register.

// r = x mod q for x < 2q (r may alias x): one chain for the borrow of
// x - q, whose words are dropped, then x - q or x - 0.  Only x is live
// across it, not x and x - q side by side.
template <class P, class R>
__device__ __forceinline__ void reduce_once(R r, const uint32_t* x) {
  constexpr int N = P::N;
  sub_cc(x[0], P::q(0));
#pragma unroll
  for (int i = 1; i < N; i++) subc_cc(x[i], P::q(i));
  const uint32_t keep = subc(0, 0);  // all ones when x < q
  r[0] = sub_cc(x[0], P::q(0) & ~keep);
#pragma unroll
  for (int i = 1; i < N - 1; i++) r[i] = subc_cc(x[i], P::q(i) & ~keep);
  r[N - 1] = subc(x[N - 1], P::q(N - 1) & ~keep);
}

// r = a + b mod q  (r may alias a or b)
template <class P, class R, class A, class B>
__device__ __forceinline__ void add_mod(R r, A a, B b) {
  constexpr int N = P::N;
  uint32_t s[N];
  s[0] = add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; i++) s[i] = addc_cc(a[i], b[i]);
  reduce_once<P>(r, s);  // a + b < 2q < 2^(32N): no carry out
}

// r = a - b mod q  (r may alias a or b)
template <class P, class R, class A, class B>
__device__ __forceinline__ void sub_mod(R r, A a, B b) {
  constexpr int N = P::N;
  uint32_t d[N];
  d[0] = sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < N; i++) d[i] = subc_cc(a[i], b[i]);
  const uint32_t mask = subc(0, 0);  // all ones when a < b: add q back
  r[0] = add_cc(d[0], P::q(0) & mask);
#pragma unroll
  for (int i = 1; i < N - 1; i++) r[i] = addc_cc(d[i], P::q(i) & mask);
  r[N - 1] = addc(d[N - 1], P::q(N - 1) & mask);
}

// acc[j], acc[j + 1] = lo, hi of a[j] b for even j < N (on a + 1: the odd
// words' products)
template <int N>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a,
                                      uint32_t b) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = a[j] * b;
    acc[j + 1] = __umulhi(a[j], b);
  }
}

// acc += sum over even j < N of a[j] b 2^(32 j), one chain; the carry out
// is left in the flag
template <int N>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a,
                                       uint32_t b) {
  acc[0] = mad_lo_cc(a[0], b, acc[0]);
  acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
  }
}

// odd <- (odd >> 64 bits) + carry in + sum over even j < N of a[j] b
// 2^(32 j): the previous row's even accumulator, shifted into the odd
// position while this row's odd products are added.  Continues the
// caller's chain; the sum is below 2q, so nothing carries out of the top.
template <int N>
__device__ __forceinline__ void madc_n_rshift(uint32_t* odd,
                                              const uint32_t* a,
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    odd[j] = madc_lo_cc(a[j], b, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(a[j], b, odd[j + 3]);
  }
  odd[N - 2] = madc_lo_cc(a[N - 2], b, 0);
  odd[N - 1] = madc_hi(a[N - 2], b, 0);
}

// One row of the product: value = even + 2^32 odd gains a b_i, then
// m q with m chosen so that even[0] becomes 0.  On entry (after the
// first row) `even` holds the previous row's odd accumulator and `odd`
// its even one, whose word 0 is 0: dividing by 2^32 adds its word 1 to
// even[0] (the carry enters the odd chain at the same weight) and shifts
// the rest down two words into the odd position.
template <class P>
__device__ __forceinline__ void mont_row(uint32_t* even, uint32_t* odd,
                                         const uint32_t* a,
                                         const uint32_t* q, uint32_t bi,
                                         bool first) {
  constexpr int N = P::N;
  if (first) {
    mul_n<N>(even, a, bi);
    mul_n<N>(odd, a + 1, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    madc_n_rshift<N>(odd, a + 1, bi);
    cmad_n<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0);
  }
  const uint32_t m = even[0] * P::NINV0;
  cmad_n<N>(odd, q + 1, m);  // odd stays below 2q: no carry out
  cmad_n<N>(even, q, m);
  odd[N - 1] = addc(odd[N - 1], 0);
}

// r = a * b * 2^(-32N) mod q   (r may alias a or b); a is read once, at
// the start, b[i] once, by row i
template <class P, class A, class B>
__device__ __forceinline__ void mont_mul(uint32_t* r, A a, B b) {
  constexpr int N = P::N;
  static_assert(N % 2 == 0, "even word count");
  uint32_t q[N], x[N], y[N], av[N];
#pragma unroll
  for (int i = 0; i < N; i++) {
    q[i] = P::q(i);
    av[i] = a[i];
  }
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mont_row<P>(x, y, av, q, b[i], i == 0);
    mont_row<P>(y, x, av, q, b[i + 1], false);
  }
  // value = (y + 2^32 x) / 2^32 with y[0] = 0, below 2q
  x[0] = add_cc(x[0], y[1]);
#pragma unroll
  for (int i = 1; i < N - 1; i++) x[i] = addc_cc(x[i], y[i + 1]);
  x[N - 1] = addc(x[N - 1], 0);
  reduce_once<P>(r, x);
}

template <int N>
__device__ __forceinline__ void load_words(uint32_t* x, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < N; i++) x[i] = src[i];
}

// N words (N % 4 == 0) from a 16-byte aligned address, as uint4 loads
template <int N>
__device__ __forceinline__ void load_words_v(uint32_t* x,
                                             const uint32_t* src) {
  static_assert(N % 4 == 0, "whole uint4s");
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < N / 4; i++) {
    const uint4 v = s[i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < N; i++) dst[i] = x[i];
}

// Every exported entry point returns the launch's cudaGetLastError()
// as an int, 0 on success.
#define TPK_EXPORT extern "C" __attribute__((visibility("default")))
