// Radix-2 NTT over Fr, batched along a leading axis.  Replaces the TPU's
// MXU NTT kernels (tpu_plonk/poly/ntt_mxu_pl.py _digit_pipeline, the int8
// digit DFT renormalise + REDC of one level, and twiddle_pl, the
// four-step twiddle boundary): here the Montgomery twiddle multiply sits
// inside each butterfly, so no digit form and no separate twiddle pass.
//
// One call = one bit-reversal gather (optionally times a per-index
// Montgomery scale, which folds the coset shift x[j] * s^j into the
// gather) followed by log2(n) in-place butterfly stages, one grid launch
// each, one thread per butterfly.  Output natural order, canonical.
//
// What bounds it on an H100: the transform must move only its input,
// its output and the twiddle table (about 21 MB at 2^18), but it issues
// (n/2) log2(n) Fr Montgomery multiplies of 264 32-bit multiply
// instructions each, so its bound is operations, not bytes.  At
// 2^18 the measured time is set by launches and latency instead: one
// launch per stage, each a short grid whose tail and launch gap are not
// hidden, with the polynomial (8 MB) kept in the 50 MB L2 across stages.
// The planned remedy is a shared-memory block that runs the first
// stages of each 2^k-point sub-transform in one launch.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int N = FrParams::N;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535LL * 8 ? 65535LL * 8 : (b < 1 ? 1 : b));
}

__global__ void bitrev_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out,
                              const uint32_t* __restrict__ scale, int log_n,
                              long long total) {
  const long long n = 1LL << log_n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t >> log_n;
    const uint32_t i = (uint32_t)(t & (n - 1));
    const uint32_t j = __brev(i) >> (32 - log_n);
    uint32_t x[N];
    load_words<N>(x, in + t * N);
    if (scale) {
      uint32_t s[N];
      load_words<N>(s, scale + (long long)i * N);
      mont_mul<FrParams>(x, x, s);
    }
    store_words<N>(out + (b * n + j) * N, x);
  }
}

// stage s: butterflies of half-width h = 2^s; twiddle w^(j * n / 2h)
// from the table of w^k, k < n/2.
__global__ void stage_kernel(uint32_t* __restrict__ data,
                             const uint32_t* __restrict__ tw, int log_n,
                             int s, long long total) {
  const long long half_n = 1LL << (log_n - 1);
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t >> (log_n - 1);
    const long long k = t & (half_n - 1);
    const long long j = k & ((1LL << s) - 1);
    const long long i0 = ((k >> s) << (s + 1)) + j;
    const long long i1 = i0 + (1LL << s);
    uint32_t* base = data + (b << log_n) * N;
    uint32_t u[N], v[N], w[N], o0[N], o1[N];
    load_words<N>(u, base + i0 * N);
    load_words<N>(v, base + i1 * N);
    load_words<N>(w, tw + (j << (log_n - 1 - s)) * N);
    mont_mul<FrParams>(v, v, w);
    add_mod<FrParams>(o0, u, v);
    sub_mod<FrParams>(o1, u, v);
    store_words<N>(base + i0 * N, o0);
    store_words<N>(base + i1 * N, o1);
  }
}

}  // namespace

// in, out: (batch, 2^log_n, 8) words; in != out.  scale: (2^log_n, 8)
// Montgomery factors applied before the transform, or null.  tw: the
// (2^(log_n-1), 8) table of w^k in Montgomery form (w or w^-1).
TPK_EXPORT int tpk_ntt(const void* in, void* out, const void* scale,
                       const void* tw, int log_n, long long batch,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = batch << log_n;
  bitrev_kernel<<<blocks_for(total), kThreads, 0, st>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)scale, log_n,
      total);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int s = 0; s < log_n; s++) {
    stage_kernel<<<blocks_for(total / 2), kThreads, 0, st>>>(
        (uint32_t*)out, (const uint32_t*)tw, log_n, s, total / 2);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
