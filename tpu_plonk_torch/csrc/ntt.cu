// Radix-2 NTT over Fr in a few shared-memory passes, batched along a
// leading axis.  Replaces the TPU's MXU NTT kernels
// (tpu_plonk/poly/ntt_mxu_pl.py _digit_pipeline, the int8 digit DFT
// renormalise + REDC of one level, and twiddle_pl, the four-step twiddle
// boundary): here the Montgomery twiddle multiply sits inside each
// butterfly, so there is no digit form and no separate twiddle pass.
//
// The transform is the decimation-in-time schedule of the plain version
// (poly/ntt.py _transform_plain: bit-reversal gather, then stages
// s = 0 .. log_n - 1 of half-width 2^s), cut into passes of consecutive
// stages.  The caller gives the plan, the stage count k of each pass
// (poly/ntt.py pass_plan: as even as possible, k <= 10, so one pass up
// to 2^10, two up to 2^20, three up to 2^30; 2 at 2^18).  A
// pass over stages [a, a + k) works on tiles of 2^k elements of one
// polynomial: every butterfly of those stages pairs elements whose
// indices differ only in bits a .. a + k - 1, so block (hi, lo) takes the
// elements (hi << (a + k)) | (m << a) | lo, m < 2^k, into shared memory,
// runs the k stages there with __syncthreads() between them, one
// butterfly a thread a stage, and writes the tile back once.  One launch
// covers the whole batch, so a call is one launch a pass.
//   - The bit reversal and the coset pre-scale x[j] * s^j fold into the
//     first pass's load: element m of its tile is gathered from input
//     index bitrev(position), times pre[that index].  Each element is one
//     32-byte sector, so the gather moves no extra bytes.
//   - The inverse's n^-1 * s^j folds into the last pass's store (`post`).
//   - Twiddles: stage a + t of block (hi, lo) uses w^(((j << a) | lo) <<
//     (log_n - 1 - a - t)) for j < 2^t, from the table of w^k.  The block
//     loads those 2^k - 1 values once, into a shared table in heap order
//     (entry 2^t + j), instead of one global load per butterfly a stage.
//
// What bounds it on an H100: the transform must move only its input,
// output and twiddle table, but it issues (n/2) log2(n) Fr Montgomery
// multiplies of 264 32-bit multiply instructions each (0.037 ms at 2^18
// on the multiply rate), so its bound is operations.  The design keeps
// the card's time near that: the data crosses device memory once a pass
// (2 passes at 2^18, against the 1 + 18 full-array launches of the
// radix-2 kernel it replaces), and every launch is a grid of batch x
// 2^(log_n - k) blocks, so no launch is a short tail.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int N = FrParams::N;
constexpr int kMaxTileLog = 10;            // 512 threads, 64 KB shared
constexpr int kMaxShared = 2 * (N * 4) << kMaxTileLog;

// stages [a, a + k) of the DIT on every tile of 2^k elements; grid =
// batch x 2^(log_n - k) blocks of 2^(k - 1) threads.  The first pass
// reads `in` (bit-reversal gather, times pre[] when given), the others
// read `out`; every pass writes `out`, the last times post[] when given.
__global__ void __launch_bounds__(1 << (kMaxTileLog - 1), 2)
pass_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            const uint32_t* __restrict__ pre,
            const uint32_t* __restrict__ post,
            const uint32_t* __restrict__ tw, int log_n, int a, int k,
            bool first, bool last) {
  extern __shared__ uint4 smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);   // 2^k elements
  uint32_t* wt = tile + (N << k);                       // heap of 2^k
  const int half = 1 << (k - 1);
  const int t = threadIdx.x;
  const int blocks_log = log_n - k;
  const long long poly = (long long)blockIdx.x >> blocks_log;
  const uint32_t blk = blockIdx.x & ((1u << blocks_log) - 1);
  const uint32_t lo = blk & ((1u << a) - 1);
  const uint32_t hi = blk >> a;
  const long long base = poly << log_n;

  // the block's twiddles, entry e = 2^s + j for stage a + s
  for (int e = t; e < (1 << k); e += half) {
    if (e == 0) continue;
    const int s = 31 - __clz(e);
    const uint32_t j = (uint32_t)(e - (1 << s));
    const uint32_t idx = ((j << a) | lo) << (log_n - 1 - a - s);
    uint32_t w[N];
    load_words_v<N>(w, tw + (long long)idx * N);
    store_words_v<N>(wt + e * N, w);
  }
  // the tile
  for (int m = t; m < (1 << k); m += half) {
    const uint32_t pos = (hi << (a + k)) | ((uint32_t)m << a) | lo;
    uint32_t x[N];
    if (first) {
      const uint32_t src = __brev(pos) >> (32 - log_n);
      load_words_v<N>(x, in + (base + src) * N);
      if (pre) {
        uint32_t s[N];
        load_words_v<N>(s, pre + (long long)src * N);
        mont_mul<FrParams>(x, x, s);
      }
    } else {
      load_words_v<N>(x, out + (base + pos) * N);
    }
    store_words_v<N>(tile + m * N, x);
  }
  __syncthreads();

  for (int s = 0; s < k; s++) {
    const int j = t & ((1 << s) - 1);
    const int m0 = ((t >> s) << (s + 1)) | j;
    const int m1 = m0 + (1 << s);
    uint32_t u[N], v[N], w[N];
    load_words_v<N>(u, tile + m0 * N);
    load_words_v<N>(v, tile + m1 * N);
    load_words_v<N>(w, wt + ((1 << s) + j) * N);
    mont_mul<FrParams>(v, v, w);
    sub_mod<FrParams>(w, u, v);
    add_mod<FrParams>(u, u, v);
    store_words_v<N>(tile + m0 * N, u);
    store_words_v<N>(tile + m1 * N, w);
    __syncthreads();
  }

  for (int m = t; m < (1 << k); m += half) {
    const uint32_t pos = (hi << (a + k)) | ((uint32_t)m << a) | lo;
    uint32_t x[N];
    load_words_v<N>(x, tile + m * N);
    if (last && post) {
      uint32_t s[N];
      load_words_v<N>(s, post + (long long)pos * N);
      mont_mul<FrParams>(x, x, s);
    }
    store_words_v<N>(out + (base + pos) * N, x);
  }
}

}  // namespace

// in, out: (batch, 2^log_n, 8) words, 16-byte aligned; in != out.  pre:
// (2^log_n, 8) Montgomery factors applied before the transform, or null.
// post: (2^log_n, 8) factors applied to the output, or null.  tw: the
// (max(1, 2^(log_n-1)), 8) table of w^k in Montgomery form (w or w^-1).
// plan: a host array of `passes` stage counts, each in 1 .. 10, summing
// to log_n.  One launch a pass.
TPK_EXPORT int tpk_ntt(const void* in, void* out, const void* pre,
                       const void* post, const void* tw, int log_n,
                       long long batch, const int* plan, int passes,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int total = 0;
  for (int p = 0; p < passes; p++) {
    if (plan[p] < 1 || plan[p] > kMaxTileLog) return cudaErrorInvalidValue;
    total += plan[p];
  }
  if (passes < 1 || total != log_n || log_n > 30)
    return cudaErrorInvalidValue;
  // tiles past 2^9 use more than the default 48 KB of shared memory
  int err = (int)cudaFuncSetAttribute(
      pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (err) return err;
  int a = 0;
  for (int p = 0; p < passes; p++) {
    const int k = plan[p];
    const long long blocks = batch << (log_n - k);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t shared = 2 * (N * 4) << k;
    pass_kernel<<<(unsigned)blocks, 1 << (k - 1), shared, st>>>(
        (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)pre,
        (const uint32_t*)post, (const uint32_t*)tw, log_n, a, k, p == 0,
        p == passes - 1);
    err = (int)cudaGetLastError();
    if (err) return err;
    a += k;
  }
  return 0;
}
