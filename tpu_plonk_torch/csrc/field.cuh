// Montgomery arithmetic over the BLS12-381 fields for one element per
// thread: little-endian 32-bit words, R = 2^(32 N) (2^256 for Fr, 2^384
// for Fp), values canonical in [0, q) on entry and on exit.  This is the
// same representation as the reference's 16-bit limbs, packed two limbs
// per word, so results compare bit for bit.
//
// The multiply is CIOS (coarsely integrated operand scanning) on 64-bit
// products: each step is one 32x32->64 multiply-add, which nvcc lowers to
// IMAD.WIDE / IMAD.HI pairs.  Both moduli leave a spare top bit
// (2q < 2^(32N)), so the running value stays below 2q and one
// conditional subtract makes it canonical.
#pragma once
#include <stdint.h>

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

// r = a + b mod q
template <class P>
__device__ __forceinline__ void add_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int N = P::N;
  uint32_t s[N], d[N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    br += (int64_t)s[i] - P::q(i);
    d[i] = (uint32_t)br;
    br >>= 32;  // arithmetic: 0 or -1
  }
  // keep s when a + b < q: no carry out of the top word and a borrow
  const bool keep = (c == 0) && (br != 0);
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = keep ? s[i] : d[i];
}

// r = a - b mod q
template <class P>
__device__ __forceinline__ void sub_mod(uint32_t* r, const uint32_t* a,
                                        const uint32_t* b) {
  constexpr int N = P::N;
  uint32_t d[N];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    br += (int64_t)a[i] - b[i];
    d[i] = (uint32_t)br;
    br >>= 32;
  }
  const uint32_t mask = br ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    c += (uint64_t)d[i] + (P::q(i) & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a * b * 2^(-32N) mod q   (r may alias a or b)
template <class P>
__device__ __forceinline__ void mont_mul(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  constexpr int N = P::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * P::NINV0;
    s = (uint64_t)m * P::q(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)m * P::q(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t < 2q: subtract q once if t >= q
  uint32_t d[N];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    br += (int64_t)t[i] - P::q(i);
    d[i] = (uint32_t)br;
    br >>= 32;
  }
  const bool keep = (t[N] == 0) && (br != 0);
#pragma unroll
  for (int i = 0; i < N; i++) r[i] = keep ? t[i] : d[i];
}

template <int N>
__device__ __forceinline__ void load_words(uint32_t* x, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < N; i++) x[i] = src[i];
}

template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* x) {
#pragma unroll
  for (int i = 0; i < N; i++) dst[i] = x[i];
}

// Every exported entry point returns the launch's cudaGetLastError()
// as an int, 0 on success.
#define TPK_EXPORT extern "C" __attribute__((visibility("default")))
