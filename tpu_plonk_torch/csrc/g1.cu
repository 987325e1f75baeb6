// G1 kernels over BLS12-381 (y^2 = x^3 + 4): projective (X:Y:Z) points in
// Montgomery form, 12 x 32-bit words per coordinate, identity (0:1:0).
//
// tpk_g1_add replaces tpu_plonk/curves/pallas_g1.py _add_tiles (K4): a
// batched complete Renes-Costello-Batina add (Algorithm 7, a = 0,
// b3 = 12), one add per thread.
// The formula is the reference's restructuring (device_g1.add): the same
// twelve products and the same sums, so the projective outputs agree
// word for word with the reference and with the plain version.  The port
// runs it in the SRS stage (the doubling ladder of the walk table).
//
// tpk_g1_walk_affine / tpk_g1_walk_proj replace
// tpu_plonk/curves/pallas_g1.py _accumulate_csr_jit (K5): one thread owns
// one row of a ragged CSR list and sums its signed 1-based table indices
// (0 = pad, skipped; negative = subtract), in list order.  The row's
// first live point is loaded, not added to the identity; on an affine
// table each later point takes the mixed add (eleven products, z2 = 1
// folded away), on a projective table the full add.  The affine walk is
// level 1 of every commit and the SRS walk, the projective one level 2
// of every commit.
//
// tpk_g1_bucket_weight is the counterpart of
// tpu_plonk/pcs/msm_csr.py _weighted_window_sums_pl_impl, the lax.scan
// that drives K4 through ~330 dependent adds per commit: per window it
// computes sum_b (b+1) B_b over the B bucket sums in at most two
// launches.  Thread s of a window takes the L consecutive buckets of
// segment s: a high-to-low running sum gives A_s = sum_j B_{sL+j} and
// T_s = sum_j (j+1) B_{sL+j} (2(L-1) adds), then P_s = T_s + (L s) A_s by
// double-and-add on s and log2 L doublings; the S = B/L terms of a
// window are summed by a stride-halving tree, first in shared memory
// within each block of T threads, then over the window's NB blocks in a
// second launch.  At c = 13 (B = 4,096, L = 16, T = 32, NB = 8) no
// thread runs more than 57 dependent adds.  pcs/msm_csr.py holds the
// plan (weighting_plan) and the plain version, which follows these
// steps in the same order, so the words agree.
//
// What bounds them on an H100: an add is 12 (mixed: 11) Fp Montgomery
// multiplies, each 588 32-bit multiply instructions, on at most 288 bytes
// of operands, so all four are bound by integer multiply issue, not by
// memory.  Every sum runs through the carry flag (field.cuh), and the
// adds are written in an order that keeps few values alive (asm volatile
// fixes that order).  The walk hides the carry chains' latency with 12
// (affine) or 16 (projective) warps a SM, which caps it at 168 or 128
// registers a thread: its accumulator and its table points sit in the
// thread's shared-memory slots and are read where the add uses them, and
// it gathers each row's next table point (cp.async, 16 bytes at a time)
// while the current add runs.  The
// weighting is latency-bound: its design cuts the dependent chain from
// ~330 launches to <= 57 adds in one thread, with every intermediate in
// registers or shared memory.
#include <cuda_runtime.h>
#include <type_traits>
#include "field.cuh"

namespace {

constexpr int M = FpParams::N;
using Fp = FpParams;

constexpr int kAddThreads = 128;
constexpr int kWalkThreads = 64;
// resident blocks of the walk per SM: 8 x 64 threads = 16 warps caps
// ptxas at 128 registers a thread, which the projective walk fits with
// no spill.  At that cap ptxas spills one word of the affine walk's
// state, so the affine walk takes 6 blocks (12 warps, 168 registers) and
// fits with none.  TPK_WALK_OVERLAP 1 lets the next entry's gather run
// under the current add (0: each add waits for it).  A build may set
// the three with -D; scripts/torch_walk_occupancy.py times such builds.
#ifndef TPK_WALK_BLOCKS
#define TPK_WALK_BLOCKS 8
#endif
#ifndef TPK_WALK_BLOCKS_AFFINE
#define TPK_WALK_BLOCKS_AFFINE 6
#endif
#ifndef TPK_WALK_OVERLAP
#define TPK_WALK_OVERLAP 1
#endif
constexpr int kWalkMinBlocks = TPK_WALK_BLOCKS;
constexpr int kWalkMinBlocksAffine = TPK_WALK_BLOCKS_AFFINE;
constexpr int kWeightMaxThreads = 32;

inline int blocks_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
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

template <class D, class S>
__device__ __forceinline__ void copy_words(D dst, S src) {
#pragma unroll
  for (int i = 0; i < M; i++) dst[i] = src[i];
}

template <class R>
__device__ __forceinline__ void times12(R r, const uint32_t* a) {
  uint32_t t4[M], t8[M];
  add_mod<Fp>(t4, a, a);
  add_mod<Fp>(t4, t4, t4);
  add_mod<Fp>(t8, t4, t4);
  add_mod<Fp>(r, t8, t4);
}

// The shared tail of the RCB formulas: from t0 = x1 x2, t1 = y1 y2,
// t2 = z1 z2, t3 = x1 y2 + x2 y1, t4 = y1 z2 + y2 z1, y3 = x1 z2 + x2 z1,
// r = (t3 t1' - t4 b3 y3 : t1' z3 + b3 y3 3 t0 : z3 t4 + 3 t0 t3) with
// z3 = t1 + b3 t2, t1' = t1 - b3 t2.  Six products; each of the six
// factors enters two of them, and the order below lets each product
// overwrite a factor whose last use it is.  The two factors that live
// longest, 3 t0 and b3 y3, go to `t0k` and `y3k`: t0 and y3 themselves,
// or 24 words of shared memory that the caller no longer needs.
// Overwrites its inputs; r is written last, so it may alias the points
// they came from.
template <class S>
__device__ __forceinline__ void rcb_tail(Pt& r, uint32_t* t0, uint32_t* t1,
                                         uint32_t* t2, uint32_t* t3,
                                         uint32_t* t4, uint32_t* y3,
                                         S t0k, S y3k) {
  uint32_t u[M], z3[M], x3[M];
  add_mod<Fp>(u, t0, t0);
  add_mod<Fp>(t0k, u, t0);           // 3 t0
  times12(t2, t2);                   // t2 = b3 t2
  add_mod<Fp>(z3, t1, t2);           // z3 = t1 + b3 t2
  sub_mod<Fp>(t1, t1, t2);           // t1 = t1 - b3 t2
  times12(y3k, y3);                  // b3 y3
  mont_mul<Fp>(x3, t3, t1);          // t3 t1
  mont_mul<Fp>(t3, t3, t0k);         // t0 t3
  mont_mul<Fp>(t1, t1, z3);          // t1 z3
  mont_mul<Fp>(z3, z3, t4);          // z3 t4
  add_mod<Fp>(z3, z3, t3);           // Z3 = z3 t4 + t0 t3
  mont_mul<Fp>(t4, t4, y3k);         // t4 y3
  sub_mod<Fp>(x3, x3, t4);           // X3 = t3 t1 - t4 y3
  mont_mul<Fp>(t4, y3k, t0k);        // y3 t0
  add_mod<Fp>(t1, t1, t4);           // Y3 = t1 z3 + y3 t0
  copy_words(r.x, x3);
  copy_words(r.y, t1);
  copy_words(r.z, z3);
}

// The tail with its long-lived factors in registers, or in the 24 words
// at `park` when one is given.
template <class S>
__device__ __forceinline__ void rcb_tail_at(Pt& r, uint32_t* t0,
                                            uint32_t* t1, uint32_t* t2,
                                            uint32_t* t3, uint32_t* t4,
                                            uint32_t* y3, S park) {
  if constexpr (std::is_null_pointer<S>::value)
    rcb_tail(r, t0, t1, t2, t3, t4, y3, t0, y3);
  else
    rcb_tail(r, t0, t1, t2, t3, t4, y3, park, park + M);
}

// r = (x1 : y1 : z1) + (x2 : y2 : z2): RCB Algorithm 7, twelve products.
// The coordinates of p (P) and of q (Q) are pointer types: into
// registers, or (the walk) `volatile` into shared memory, so that each
// is read where it is used; they may alias each other and r, which is
// written last.  Each product takes q's word as its second factor, and
// p's coordinates die as early as the formula allows.  `park`, if given,
// is 12 words of shared memory for the tail's 3 t0.
template <class P, class Q, class S = std::nullptr_t>
__device__ __forceinline__ void point_add(Pt& r, P x1, P y1, P z1, Q x2,
                                          Q y2, Q z2, S park = nullptr) {
  uint32_t t0[M], t1[M], t2[M], t3[M], t4[M], y3[M], u[M];
  add_mod<Fp>(u, x1, y1);
  add_mod<Fp>(t3, x2, y2);
  mont_mul<Fp>(t3, u, t3);           // (x1+y1)(x2+y2)
  mont_mul<Fp>(t0, x1, x2);
  add_mod<Fp>(u, x1, z1);
  add_mod<Fp>(y3, x2, z2);
  mont_mul<Fp>(y3, u, y3);           // (x1+z1)(x2+z2)
  mont_mul<Fp>(t2, z1, z2);
  mont_mul<Fp>(t1, y1, y2);
  add_mod<Fp>(u, y1, z1);
  add_mod<Fp>(t4, y2, z2);
  mont_mul<Fp>(t4, u, t4);           // (y1+z1)(y2+z2)
  add_mod<Fp>(u, t0, t1);
  sub_mod<Fp>(t3, t3, u);            // t3 = (x1+y1)(x2+y2) - t0 - t1
  add_mod<Fp>(u, t1, t2);
  sub_mod<Fp>(t4, t4, u);            // t4 = (y1+z1)(y2+z2) - t1 - t2
  add_mod<Fp>(u, t0, t2);
  sub_mod<Fp>(y3, y3, u);            // y3 = (x1+z1)(x2+z2) - t0 - t2
  rcb_tail_at(r, t0, t1, t2, t3, t4, y3, park);
}

// r = (x1 : y1 : z1) + (x2 : y2 : 1): RCB Algorithm 8, eleven products,
// with point_add's operand conventions.  Every intermediate is the field
// value Algorithm 7 computes with z2 = 1, so the words equal point_add's
// on the same inputs.
template <class P, class Q, class S = std::nullptr_t>
__device__ __forceinline__ void point_add_mixed(Pt& r, P x1, P y1, P z1,
                                                Q x2, Q y2,
                                                S park = nullptr) {
  uint32_t t0[M], t1[M], t2[M], t3[M], t4[M], y3[M], u[M];
  add_mod<Fp>(u, x1, y1);
  add_mod<Fp>(t3, x2, y2);
  mont_mul<Fp>(t3, u, t3);           // (x1+y1)(x2+y2)
  mont_mul<Fp>(t0, x1, x2);
  mont_mul<Fp>(y3, z1, x2);
  add_mod<Fp>(y3, y3, x1);           // y3 = x2 z1 + x1
  mont_mul<Fp>(t1, y1, y2);
  mont_mul<Fp>(t4, z1, y2);
  add_mod<Fp>(t4, t4, y1);           // t4 = y2 z1 + y1
  add_mod<Fp>(u, t0, t1);
  sub_mod<Fp>(t3, t3, u);            // t3 = (x1+y1)(x2+y2) - t0 - t1
  copy_words(t2, z1);
  rcb_tail_at(r, t0, t1, t2, t3, t4, y3, park);
}

template <class Y>
__device__ __forceinline__ void negate(Y y) {
  uint32_t zero[M];
#pragma unroll
  for (int i = 0; i < M; i++) zero[i] = 0;
  sub_mod<Fp>(y, zero, y);
}

__device__ __forceinline__ void load_point(Pt& p, const uint32_t* src) {
  load_words_v<M>(p.x, src);
  load_words_v<M>(p.y, src + M);
  load_words_v<M>(p.z, src + 2 * M);
}

__device__ __forceinline__ void store_point(uint32_t* dst, const Pt& p) {
  store_words<M>(dst, p.x);
  store_words<M>(dst + M, p.y);
  store_words<M>(dst + 2 * M, p.z);
}

__global__ void add_kernel(const uint32_t* __restrict__ p, long long np,
                           const uint32_t* __restrict__ q, long long nq,
                           uint32_t* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    Pt a, b;
    load_point(a, p + (i % np) * 3 * M);
    load_point(b, q + (i % nq) * 3 * M);
    point_add(a, a.x, a.y, a.z, b.x, b.y, b.z);
    store_point(out + i * 3 * M, a);
  }
}

// Each thread walks one row.  Its accumulator and two table points sit
// in its own shared-memory slots: the entry it adds now and the row's
// next live entry, whose 16-byte copies are issued before the add.  Only
// the owning thread touches a slot, so cp.async.wait_group alone orders
// the copy and the read.  The add reads every coordinate through a
// volatile pointer where it uses it and keeps its tail's two
// longest-lived factors in the table point's slot once the point is
// dead; the row's length and entries are re-read where they are needed
// (volatile loads, which ptxas emits as LDG.E.STRONG.SYS: they are not
// kept in L1, and next_live issues them again for each entry).  So
// across an add only one register of the row's state stays live: the
// position in the row and which slot holds the current point.  A row
// with no live entry stays the identity.
template <bool kAffine>
__global__ void
__launch_bounds__(kWalkThreads,
                  kAffine ? kWalkMinBlocksAffine : kWalkMinBlocks)
walk_kernel(const uint32_t* __restrict__ tbl, const int32_t* idx,
            const int32_t* row_start, const int32_t* row_len,
            uint32_t* __restrict__ out, int n_rows) {
  constexpr int kWords = kAffine ? 2 * M : 3 * M;
  constexpr int kSlot = kWalkThreads * kWords;   // slot k: + k * kSlot
  __shared__ __align__(16) uint32_t slots[2][kWalkThreads][kWords];
  __shared__ uint32_t accs[kWalkThreads][3 * M];
  const int r = blockIdx.x * kWalkThreads + threadIdx.x;
  if (r >= n_rows) return;
  uint32_t* const mine = slots[0][threadIdx.x];
  volatile uint32_t* const acc = accs[threadIdx.x];
  const volatile int32_t* vidx = idx;
  const volatile int32_t* vstart = row_start;
  const volatile int32_t* vlen = row_len;
  auto len = [&] { return vlen[r]; };
  auto entry = [&](int k) { return vidx[vstart[r] + k]; };
  auto next_live = [&](int k) {
    while (k < len() && entry(k) == 0) k++;
    return k;
  };
  auto fetch = [&](uint32_t* slot, int k) {
    const int32_t e = entry(k);
    const uint32_t* src =
        tbl + (long long)((e < 0 ? -e : e) - 1) * kWords;
#pragma unroll
    for (int v = 0; v < kWords / 4; v++)
      cp_async16(slot + 4 * v, src + 4 * v);
  };
  // the row's first live entry, taken as it is (z = 1 on an affine table)
  int k = next_live(0);
  if (k < len()) fetch(mine, k);
  cp_async_commit();
  cp_async_wait<0>();
  if (k < len()) {
    volatile uint32_t* q = mine;
    if (entry(k) < 0) negate(q + M);
    copy_words(acc, q);
    copy_words(acc + M, q + M);
    if constexpr (kAffine) {
#pragma unroll
      for (int i = 0; i < M; i++) acc[2 * M + i] = fp_one(i);
    } else {
      copy_words(acc + 2 * M, q + 2 * M);
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; i++) {
      acc[i] = 0;
      acc[M + i] = fp_one(i);
      acc[2 * M + i] = 0;
    }
  }
  // state = 2 * (position of the current entry) + (the slot holding it)
  k = next_live(k + 1);
  if (k < len()) fetch(mine + kSlot, k);
  cp_async_commit();
  int state = 2 * k + 1;
  while (state / 2 < len()) {
    const int cur = state & 1;
    const int kn = next_live(state / 2 + 1);
    if (kn < len()) fetch(mine + (cur ^ 1) * kSlot, kn);
    cp_async_commit();
    cp_async_wait<TPK_WALK_OVERLAP>();   // this entry's copies landed
    volatile uint32_t* q = mine + cur * kSlot;
    if (entry(state / 2) < 0) negate(q + M);
    Pt sum;
    if (kAffine)
      point_add_mixed(sum, acc, acc + M, acc + 2 * M, q, q + M, q);
    else
      point_add(sum, acc, acc + M, acc + 2 * M, q, q + M, q + 2 * M, q);
    copy_words(acc, sum.x);
    copy_words(acc + M, sum.y);
    copy_words(acc + 2 * M, sum.z);
    state = 2 * kn + (cur ^ 1);
  }
  cp_async_wait<0>();
  uint32_t* o = out + (long long)r * 3 * M;
#pragma unroll
  for (int i = 0; i < 3 * M; i++) o[i] = acc[i];
}

// r = p + q for three points anywhere in memory (r may alias p or q): the
// weighting's one add, out of line so that its call sites share one
// compiled body.
__device__ __noinline__ void add_points(uint32_t* r, const uint32_t* p,
                                        const uint32_t* q) {
  Pt a;
  copy_words(a.x, p);
  copy_words(a.y, p + M);
  copy_words(a.z, p + 2 * M);
  point_add(a, a.x, a.y, a.z, q, q + M, q + 2 * M);
  store_point(r, a);
}

__device__ __forceinline__ void copy_point(uint32_t* dst,
                                           const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < 3 * M; i++) dst[i] = src[i];
}

// Sums the block's points v[t] (blockDim.x a power of two), stride
// halving: at each level thread t < h adds v[t + h] to v[t].  The sum
// lands in v[0].
__device__ __forceinline__ void block_tree_sum(uint32_t (*v)[3 * M]) {
  const int t = threadIdx.x;
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (t < h) add_points(v[t], v[t], v[t + h]);
  }
  __syncthreads();
}

// Block (nb, w) of T threads: thread t takes segment s = nb T + t of
// window w, buckets [s L, s L + L), and the block writes the sum of its
// T terms P_s to out[w, nb].  Each thread's running sum, total and A_s
// live in shared memory.
__global__ void __launch_bounds__(kWeightMaxThreads)
weight_kernel(const uint32_t* __restrict__ buckets, int B, int L,
              uint32_t* __restrict__ out) {
  __shared__ uint32_t tot[kWeightMaxThreads][3 * M];
  __shared__ uint32_t run[kWeightMaxThreads][3 * M];
  __shared__ uint32_t seg_sum[kWeightMaxThreads][3 * M];
  const int t = threadIdx.x;
  const int s = blockIdx.x * blockDim.x + t;
  const uint32_t* seg =
      buckets + ((long long)blockIdx.y * B + (long long)s * L) * 3 * M;
  copy_point(run[t], seg + (L - 1) * 3 * M);
  copy_point(tot[t], run[t]);
  for (int j = L - 2; j >= 0; j--) {
    add_points(run[t], run[t], seg + j * 3 * M);
    add_points(tot[t], tot[t], run[t]);
  }
  if (s > 0) {
    // (L s) A_s: double-and-add from the top bit of s
    copy_point(seg_sum[t], run[t]);
    for (int i = 30 - __clz(s); i >= 0; i--) {
      add_points(run[t], run[t], run[t]);
      if ((s >> i) & 1) add_points(run[t], run[t], seg_sum[t]);
    }
    for (int l = L; l > 1; l >>= 1) add_points(run[t], run[t], run[t]);
    add_points(tot[t], tot[t], run[t]);
  }
  block_tree_sum(tot);
  if (t == 0)
    copy_point(out + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 3 * M,
               tot[0]);
}

// Block w of NB threads: the tree over window w's NB block sums.
__global__ void __launch_bounds__(kWeightMaxThreads)
weight_tree_kernel(const uint32_t* __restrict__ partial,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t v[kWeightMaxThreads][3 * M];
  const int t = threadIdx.x;
  copy_point(v[t], partial + ((long long)blockIdx.x * blockDim.x + t) * 3 * M);
  block_tree_sum(v);
  if (t == 0) copy_point(out + (long long)blockIdx.x * 3 * M, v[0]);
}

inline bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// p: (np, 3, 12), q: (nq, 3, 12) words; lane i adds p[i % np] and
// q[i % nq]; out (n, 3, 12).
TPK_EXPORT int tpk_g1_add(const void* p, long long np, const void* q,
                          long long nq, void* out, long long n,
                          void* stream) {
  add_kernel<<<blocks_for(n, kAddThreads), kAddThreads, 0,
               (cudaStream_t)stream>>>(
      (const uint32_t*)p, np, (const uint32_t*)q, nq, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// tbl: (P, 2, 12) affine or (P, 3, 12) projective words, 16-byte aligned;
// idx: signed 1-based table indices; row r sums idx[row_start[r] .. +
// row_len[r]); out: (n_rows, 3, 12).
template <bool kAffine>
static int walk(const void* tbl, const void* idx, const void* row_start,
                const void* row_len, void* out, long long n_rows,
                void* stream) {
  if (n_rows < 1 || n_rows > 0x7fffffffLL - kWalkThreads)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks =
      (unsigned)((n_rows + kWalkThreads - 1) / kWalkThreads);
  walk_kernel<kAffine><<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, (const int32_t*)idx, (const int32_t*)row_start,
      (const int32_t*)row_len, (uint32_t*)out, (int)n_rows);
  return (int)cudaGetLastError();
}

TPK_EXPORT int tpk_g1_walk_affine(const void* tbl, const void* idx,
                                  const void* row_start, const void* row_len,
                                  void* out, long long n_rows, void* stream) {
  return walk<true>(tbl, idx, row_start, row_len, out, n_rows, stream);
}

TPK_EXPORT int tpk_g1_walk_proj(const void* tbl, const void* idx,
                                const void* row_start, const void* row_len,
                                void* out, long long n_rows, void* stream) {
  return walk<false>(tbl, idx, row_start, row_len, out, n_rows, stream);
}

// buckets: (W, B, 3, 12) words, 16-byte aligned; out: (W, 3, 12) weighted
// window sums.  The plan (L buckets a segment, T threads a block, NB
// blocks a window, L T NB = B, T and NB powers of two up to 32) comes from
// the wrapper; partial: (W, NB, 3, 12) scratch when NB > 1, else unused.
TPK_EXPORT int tpk_g1_bucket_weight(const void* buckets, long long W, int B,
                                    int L, int T, int NB, void* partial,
                                    void* out, void* stream) {
  if (W < 1 || W > 65535 || L < 1 || !pow2(T) || !pow2(NB) ||
      T > kWeightMaxThreads || NB > kWeightMaxThreads ||
      (long long)L * T * NB != B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  weight_kernel<<<dim3(NB, (unsigned)W), T, 0, st>>>(
      (const uint32_t*)buckets, B, L, (uint32_t*)(NB > 1 ? partial : out));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || NB == 1) return (int)err;
  weight_tree_kernel<<<(unsigned)W, NB, 0, st>>>((const uint32_t*)partial,
                                                 (uint32_t*)out);
  return (int)cudaGetLastError();
}
