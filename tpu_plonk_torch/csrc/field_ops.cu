// Elementwise field kernels: Fr Montgomery multiply (replaces the TPU's
// fused Pallas multiply, tpu_plonk/fields/pallas_fr.py _mul_tiles), Fr
// add/sub mod r and Fp Montgomery multiply (the reference runs both as
// XLA, tpu_plonk/fields/device.py add_mod/sub_mod/mont_mul).
//
// One element per thread, grid-stride.  Operand b (and a) may hold fewer
// rows than the output: row i reads row i % nb, which covers a scalar
// broadcast (nb == 1) and a table repeated over a batch (nb == n / B).
//
// What bounds it on an H100: an Fr multiply moves 96 bytes (two 32-byte
// operands in, one out) against 136 32x32->64 multiplies, so at
// 3.35 TB/s and ~16.7 T int32 multiply issues/s the bytes bound it; the
// design keeps every intermediate in registers and reads each operand
// word once, so the only traffic is those 96 bytes.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int kThreads = 256;

inline int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b > 65535LL * 8 ? 65535LL * 8 : (b < 1 ? 1 : b));
}

// operand row of output row i: the common cases skip the 64-bit modulo
__device__ __forceinline__ long long row(long long i, long long rows,
                                         long long n) {
  return rows == n ? i : (rows == 1 ? 0 : i % rows);
}

template <class P>
__global__ void mul_kernel(const uint32_t* __restrict__ a, long long na,
                           const uint32_t* __restrict__ b, long long nb,
                           uint32_t* __restrict__ out, long long n) {
  constexpr int N = P::N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[N], y[N], r[N];
    load_words<N>(x, a + row(i, na, n) * N);
    load_words<N>(y, b + row(i, nb, n) * N);
    mont_mul<P>(r, x, y);
    store_words<N>(out + i * N, r);
  }
}

template <class P>
__global__ void addsub_kernel(const uint32_t* __restrict__ a, long long na,
                              const uint32_t* __restrict__ b, long long nb,
                              uint32_t* __restrict__ out, long long n,
                              int subtract) {
  constexpr int N = P::N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t x[N], y[N], r[N];
    load_words<N>(x, a + row(i, na, n) * N);
    load_words<N>(y, b + row(i, nb, n) * N);
    if (subtract)
      sub_mod<P>(r, x, y);
    else
      add_mod<P>(r, x, y);
    store_words<N>(out + i * N, r);
  }
}

}  // namespace

TPK_EXPORT int tpk_fr_mul(const void* a, long long na, const void* b,
                          long long nb, void* out, long long n,
                          void* stream) {
  mul_kernel<FrParams><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

TPK_EXPORT int tpk_fr_addsub(const void* a, long long na, const void* b,
                             long long nb, void* out, long long n,
                             int subtract, void* stream) {
  addsub_kernel<FrParams>
      <<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)a, na, (const uint32_t*)b, nb, (uint32_t*)out, n,
          subtract);
  return (int)cudaGetLastError();
}

TPK_EXPORT int tpk_fp_mul(const void* a, long long na, const void* b,
                          long long nb, void* out, long long n,
                          void* stream) {
  mul_kernel<FpParams><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

TPK_EXPORT const char* tpk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
