// G1 kernels over BLS12-381 (y^2 = x^3 + 4): projective (X:Y:Z) points in
// Montgomery form, 12 x 32-bit words per coordinate, identity (0:1:0).
//
// tpk_g1_add replaces tpu_plonk/curves/pallas_g1.py _add_tiles (K4): a
// batched complete Renes-Costello-Batina add (Algorithm 7, a = 0,
// b3 = 12) with an optional negation of q per lane, one add per thread.
// The formula is the reference's restructuring (device_g1.add): the same
// twelve products and the same sums, so the projective outputs agree
// word for word with the reference and with the plain version.
//
// tpk_g1_walk replaces tpu_plonk/curves/pallas_g1.py _accumulate_csr_jit
// (K5): one thread owns one row of a ragged CSR list and sums its signed
// 1-based table indices (0 = pad, skipped; negative = subtract) into an
// accumulator held in registers.  The row's first live point is loaded,
// not added to the identity, and on an affine table each later point
// takes the mixed add (eleven products, z2 = 1 folded away); on a
// projective table the full add.  Used by every commit's two bucket
// levels and by the SRS walk.
//
// What bounds them on an H100: an add is 12 (mixed: 11) Fp Montgomery
// multiplies, each 588 32-bit multiply instructions, on at most 288
// bytes of operands, so both kernels are bound by integer multiply
// issue, not by memory; the design keeps the accumulator and every
// temporary in registers (ptxas reports the count and any spills),
// reads each table point once per use, and does no product the sum does
// not need.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int M = FpParams::N;
using Fp = FpParams;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535LL * 8 ? 65535LL * 8 : (b < 1 ? 1 : b));
}

__device__ __forceinline__ uint32_t fp_one(int i) {
  const uint32_t ONE[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u,
                            0xebf4000bu, 0x53c758bau, 0x5f489857u,
                            0x70525745u, 0x77ce5853u, 0xa256ec6du,
                            0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
  return ONE[i];
}

struct Pt {
  uint32_t x[M], y[M], z[M];
};

__device__ __forceinline__ void times12(uint32_t* r, const uint32_t* a) {
  uint32_t t4[M], t8[M];
  add_mod<Fp>(t4, a, a);
  add_mod<Fp>(t4, t4, t4);
  add_mod<Fp>(t8, t4, t4);
  add_mod<Fp>(r, t8, t4);
}

// The shared tail of the RCB formulas: from t0 = x1 x2, t1 = y1 y2,
// t2 = z1 z2, t3 = x1 y2 + x2 y1, t4 = y1 z2 + y2 z1, y3 = x1 z2 + x2 z1,
// r = (t3 t1' - t4 b3 y3 : t1' z3 + b3 y3 3 t0 : z3 t4 + 3 t0 t3) with
// z3 = t1 + b3 t2, t1' = t1 - b3 t2.  Six products.  r may alias inputs.
__device__ __forceinline__ void rcb_tail(Pt& r, uint32_t* t0, uint32_t* t1,
                                         uint32_t* t2, uint32_t* t3,
                                         uint32_t* t4, uint32_t* y3) {
  uint32_t u[M], v[M];
  add_mod<Fp>(u, t0, t0);
  add_mod<Fp>(t0, u, t0);            // t0 = 3 t0
  times12(t2, t2);                   // t2 = b3 t2
  add_mod<Fp>(v, t1, t2);            // v = z3 = t1 + b3 t2
  sub_mod<Fp>(t1, t1, t2);           // t1 = t1 - b3 t2
  times12(y3, y3);                   // y3 = b3 y3
  uint32_t x3[M], yo[M], zo[M];
  mont_mul<Fp>(x3, t3, t1);
  mont_mul<Fp>(u, t4, y3);
  sub_mod<Fp>(x3, x3, u);
  mont_mul<Fp>(yo, t1, v);
  mont_mul<Fp>(u, y3, t0);
  add_mod<Fp>(yo, yo, u);
  mont_mul<Fp>(zo, v, t4);
  mont_mul<Fp>(u, t0, t3);
  add_mod<Fp>(zo, zo, u);
#pragma unroll
  for (int i = 0; i < M; i++) {
    r.x[i] = x3[i];
    r.y[i] = yo[i];
    r.z[i] = zo[i];
  }
}

// r = p + q (r may alias p or q): RCB Algorithm 7, twelve products.
__device__ __forceinline__ void point_add(Pt& r, const Pt& p, const Pt& q) {
  uint32_t t0[M], t1[M], t2[M], t3[M], t4[M], y3[M], u[M], v[M];
  mont_mul<Fp>(t0, p.x, q.x);
  mont_mul<Fp>(t1, p.y, q.y);
  mont_mul<Fp>(t2, p.z, q.z);
  add_mod<Fp>(u, p.x, p.y);
  add_mod<Fp>(v, q.x, q.y);
  mont_mul<Fp>(t3, u, v);
  add_mod<Fp>(u, p.y, p.z);
  add_mod<Fp>(v, q.y, q.z);
  mont_mul<Fp>(t4, u, v);
  add_mod<Fp>(u, p.x, p.z);
  add_mod<Fp>(v, q.x, q.z);
  mont_mul<Fp>(y3, u, v);
  add_mod<Fp>(u, t0, t1);
  sub_mod<Fp>(t3, t3, u);            // t3 = (x1+y1)(x2+y2) - t0 - t1
  add_mod<Fp>(u, t1, t2);
  sub_mod<Fp>(t4, t4, u);            // t4 = (y1+z1)(y2+z2) - t1 - t2
  add_mod<Fp>(u, t0, t2);
  sub_mod<Fp>(y3, y3, u);            // y3 = (x1+z1)(x2+z2) - t0 - t2
  rcb_tail(r, t0, t1, t2, t3, t4, y3);
}

// r = p + (x2 : y2 : 1) (r may alias p): RCB Algorithm 8, eleven
// products.  Every intermediate is the field value Algorithm 7 computes
// with z2 = 1, so the words equal point_add's on the same inputs.
__device__ __forceinline__ void point_add_mixed(Pt& r, const Pt& p,
                                                const uint32_t* x2,
                                                const uint32_t* y2) {
  uint32_t t0[M], t1[M], t2[M], t3[M], t4[M], y3[M], u[M], v[M];
  mont_mul<Fp>(t0, p.x, x2);
  mont_mul<Fp>(t1, p.y, y2);
  add_mod<Fp>(u, p.x, p.y);
  add_mod<Fp>(v, x2, y2);
  mont_mul<Fp>(t3, u, v);
  add_mod<Fp>(u, t0, t1);
  sub_mod<Fp>(t3, t3, u);            // t3 = (x1+y1)(x2+y2) - t0 - t1
  mont_mul<Fp>(t4, y2, p.z);
  add_mod<Fp>(t4, t4, p.y);          // t4 = y2 z1 + y1
  mont_mul<Fp>(y3, x2, p.z);
  add_mod<Fp>(y3, y3, p.x);          // y3 = x2 z1 + x1
#pragma unroll
  for (int i = 0; i < M; i++) t2[i] = p.z[i];
  rcb_tail(r, t0, t1, t2, t3, t4, y3);
}

__device__ __forceinline__ void negate(uint32_t* y) {
  uint32_t zero[M];
#pragma unroll
  for (int i = 0; i < M; i++) zero[i] = 0;
  sub_mod<Fp>(y, zero, y);
}

__device__ __forceinline__ void load_point(Pt& p, const uint32_t* src) {
  load_words<M>(p.x, src);
  load_words<M>(p.y, src + M);
  load_words<M>(p.z, src + 2 * M);
}

__global__ void add_kernel(const uint32_t* __restrict__ p, long long np,
                           const uint32_t* __restrict__ q, long long nq,
                           const int32_t* __restrict__ neg,
                           uint32_t* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    Pt a, b;
    load_point(a, p + (i % np) * 3 * M);
    load_point(b, q + (i % nq) * 3 * M);
    if (neg && neg[i]) negate(b.y);
    point_add(a, a, b);
    store_words<M>(out + i * 3 * M, a.x);
    store_words<M>(out + i * 3 * M + M, a.y);
    store_words<M>(out + i * 3 * M + 2 * M, a.z);
  }
}

// A row's first live entry is loaded into the accumulator, each later
// one added (mixed add on an affine table); a row with none stays the
// identity.
template <bool kAffine>
__global__ void walk_kernel(const uint32_t* __restrict__ tbl,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ row_start,
                            const int32_t* __restrict__ row_len,
                            uint32_t* __restrict__ out, long long n_rows) {
  constexpr int stride = kAffine ? 2 * M : 3 * M;
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       r < n_rows; r += (long long)gridDim.x * blockDim.x) {
    Pt acc;
#pragma unroll
    for (int i = 0; i < M; i++) {
      acc.x[i] = 0;
      acc.y[i] = fp_one(i);
      acc.z[i] = 0;
    }
    bool fresh = true;
    const int32_t* e = idx + row_start[r];
    const int len = row_len[r];
    for (int k = 0; k < len; k++) {
      const int32_t s = e[k];
      if (s == 0) continue;
      const uint32_t* src =
          tbl + ((s < 0 ? -(long long)s : (long long)s) - 1) * stride;
      if (kAffine) {
        uint32_t x2[M], y2[M];
        load_words<M>(x2, src);
        load_words<M>(y2, src + M);
        if (s < 0) negate(y2);
        if (fresh) {
#pragma unroll
          for (int i = 0; i < M; i++) {
            acc.x[i] = x2[i];
            acc.y[i] = y2[i];
            acc.z[i] = fp_one(i);
          }
        } else {
          point_add_mixed(acc, acc, x2, y2);
        }
      } else {
        Pt q;
        load_point(q, src);
        if (s < 0) negate(q.y);
        if (fresh) {
          acc = q;
        } else {
          point_add(acc, acc, q);
        }
      }
      fresh = false;
    }
    store_words<M>(out + r * 3 * M, acc.x);
    store_words<M>(out + r * 3 * M + M, acc.y);
    store_words<M>(out + r * 3 * M + 2 * M, acc.z);
  }
}

}  // namespace

// p: (np, 3, 12), q: (nq, 3, 12) words; lane i adds p[i % np] and
// q[i % nq] (negated where neg[i] != 0; neg may be null); out (n, 3, 12).
TPK_EXPORT int tpk_g1_add(const void* p, long long np, const void* q,
                          long long nq, const void* neg, void* out,
                          long long n, void* stream) {
  add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, np, (const uint32_t*)q, nq, (const int32_t*)neg,
      (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// tbl: (P, 2, 12) affine or (P, 3, 12) projective words; idx: signed
// 1-based table indices; row r sums idx[row_start[r] .. + row_len[r]);
// out: (n_rows, 3, 12).
TPK_EXPORT int tpk_g1_walk(const void* tbl, int affine, const void* idx,
                           const void* row_start, const void* row_len,
                           void* out, long long n_rows, void* stream) {
  auto kernel = affine ? walk_kernel<true> : walk_kernel<false>;
  kernel<<<blocks_for(n_rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, (const int32_t*)idx, (const int32_t*)row_start,
      (const int32_t*)row_len, (uint32_t*)out, n_rows);
  return (int)cudaGetLastError();
}
