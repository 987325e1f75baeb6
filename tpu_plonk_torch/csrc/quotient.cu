// The quotient-phase body (replaces the TPU's fused Pallas kernel,
// tpu_plonk/proof_system/quotient_pallas.py _kernel / the pallas_call of
// _run_tiles_impl): at every point of one interleaved size-n coset s_i*H,
// the gate constraint (arith, range, logic, fixed-base and variable-base
// ECC widgets), the permutation term, the L1 term, all scaled by the
// phase's constant Z_H^-1.  Same order of operations as the reference;
// the field ops are exact on canonical Montgomery values, so the result
// is bit-identical to the plain version (proof_system/quotient.py).
//
// One point per thread, grid-stride.  The next-row values a', b', d', z'
// are read here at row (j + 1) mod n, so no rolled copy of any input
// exists: 23 (n, 8) inputs in, one out.  The challenge constants arrive
// as an (18, 8) table in the reference's _COLS order; the block derives
// the powers it needs (kappa^2.., alpha^2, beta * k_j) once into shared
// memory, so per point only products with a point-dependent operand
// remain: 107 Fr multiplies (quotient.MULS_PER_POINT).
//
// What bounds it on an H100: 107 x 264 32-bit multiply instructions per
// point (~0.44 ms at 2^18 against ~0.06 ms for its 24 x 32 bytes per
// point), so it is bound by multiply issue.  The design keeps every
// intermediate in registers and folds each widget into the running gate
// value before the next starts, each widget loading the inputs it uses
// (from L1 when a later widget reads it again), so few 8-word
// values are live at once.
#include <cuda_runtime.h>
#include "field.cuh"

namespace {

constexpr int kThreads = 128;

// input order (quotient.py IN_NAMES)
enum In {
  A, B, C, D, Z, PI,
  QM, QL, QR, QO, Q4, QC, QARITH, QRANGE, QLOGIC, QFIXED, QVGADD,
  S1, S2, S3, S4, XPTS, L1V, N_IN
};
// constant-table rows (quotient.py COLS; rows 0-1, the modulus and
// -q^-1, are the reference's REDC inputs and unused here)
enum Col {
  C_MOD, C_NINV, C_ONE, C_BETA, C_GAMMA, C_ALPHA, C_KR, C_KL, C_KF, C_KV,
  C_ZH, C_JD, C_C83, C_C27, C_C23, C_K1, C_K2, C_K3, N_COL
};
// the block's shared scalars: the table rows plus derived powers
enum Sc {
  S_ALPHA2 = N_COL, S_KR2, S_KR3, S_KL2, S_KL3, S_KL4, S_KF2, S_KF3, S_KV2,
  S_BK1, S_BK2, S_BK3, N_SC
};

struct Inputs {
  const uint32_t* p[N_IN];
};

struct Fe {
  uint32_t w[8];
};

__device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
  Fe r;
  mont_mul<FrParams>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe r;
  add_mod<FrParams>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
  Fe r;
  sub_mod<FrParams>(r.w, a.w, b.w);
  return r;
}

__device__ __forceinline__ Fe x2(const Fe& v) { return add(v, v); }
__device__ __forceinline__ Fe x3(const Fe& v) { return add(x2(v), v); }
__device__ __forceinline__ Fe x4(const Fe& v) { return x2(x2(v)); }

__device__ __forceinline__ Fe ld(const uint32_t* __restrict__ p,
                                 long long row) {
  Fe r;
  load_words<8>(r.w, p + row * 8);
  return r;
}

typedef uint32_t (*Scalars)[8];

__device__ __forceinline__ Fe sc(Scalars s, int k) {
  Fe r;
  load_words<8>(r.w, s[k]);
  return r;
}

// v (v - 1) (v - 2) (v - 3)
__device__ __forceinline__ Fe delta(const Fe& v, const Fe& one) {
  const Fe two = x2(one);
  const Fe three = add(two, one);
  return mul(mul(v, sub(v, one)), mul(sub(v, two), sub(v, three)));
}

__device__ __forceinline__ void put(Scalars s, int k, const Fe& v) {
  store_words<8>(s[k], v.w);
}

// Each widget is a function of its own, not inlined: it loads its
// inputs, computes its term and returns it, so only the running gate
// value lives across the calls, and ptxas allocates registers for six
// functions of ~20 multiplies each.  One function of all 107 inlined
// multiplies takes ptxas about three minutes and spills past 255
// registers.  `p` and `s` point to the block's shared copies of the
// input pointers and the scalars.
#define TERM __device__ __noinline__ Fe

// q_arith (q_m ab + q_l a + q_r b + q_4 d + q_o c + q_c) + pi
TERM arith_term(const uint32_t* const* p, Scalars s, long long i) {
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  Fe t = mul(ld(p[QM], i), mul(a, b));
  t = add(t, mul(ld(p[QL], i), a));
  t = add(t, mul(ld(p[QR], i), b));
  t = add(t, mul(ld(p[Q4], i), ld(p[D], i)));
  t = add(t, mul(ld(p[QO], i), ld(p[C], i)));
  t = add(t, ld(p[QC], i));
  return add(mul(ld(p[QARITH], i), t), ld(p[PI], i));
}

// kr q_range (D(c-4d) + kr D(b-4c) + kr^2 D(a-4b) + kr^3 D(d'-4a))
TERM range_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe one = sc(s, C_ONE);
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  const Fe c = ld(p[C], i), d = ld(p[D], i);
  Fe r = delta(sub(c, x4(d)), one);
  r = add(r, mul(sc(s, C_KR), delta(sub(b, x4(c)), one)));
  r = add(r, mul(sc(s, S_KR2), delta(sub(a, x4(b)), one)));
  r = add(r, mul(sc(s, S_KR3), delta(sub(ld(p[D], j), x4(a)), one)));
  return mul(mul(sc(s, C_KR), ld(p[QRANGE], i)), r);
}

// kl q_logic (2-bit quads, product wire on the current row's c)
TERM logic_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe one = sc(s, C_ONE);
  const Fe c = ld(p[C], i);
  const Fe qa = sub(ld(p[A], j), x4(ld(p[A], i)));
  const Fe qb = sub(ld(p[B], j), x4(ld(p[B], i)));
  const Fe qd = sub(ld(p[D], j), x4(ld(p[D], i)));
  Fe g = delta(qa, one);
  g = add(g, mul(sc(s, C_KL), delta(qb, one)));
  g = add(g, mul(sc(s, S_KL2), delta(qd, one)));
  g = add(g, mul(sc(s, S_KL3), sub(c, mul(qa, qb))));
  const Fe sm = add(qa, qb);
  const Fe sq = add(mul(qa, qa), mul(qb, qb));
  const Fe w2 = mul(c, c);
  const Fe andv =
      sub(add(add(mul(sc(s, C_C83), c), x3(mul(c, sq))),
              add(mul(sc(s, C_C27), w2), mul(sc(s, C_C23), mul(w2, c)))),
          add(mul(mul(sc(s, C_C27), c), sm), x3(mul(w2, sm))));
  const Fe qc = ld(p[QC], i);
  const Fe g5 = sub(qd, add(mul(qc, sm), mul(sub(one, x3(qc)), andv)));
  g = add(g, mul(sc(s, S_KL4), g5));
  return mul(mul(sc(s, C_KL), ld(p[QLOGIC], i)), g);
}

// kf q_fixed (fixed-base ECC ladder row)
TERM fixed_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe one = sc(s, C_ONE);
  const Fe a = ld(p[A], i), b = ld(p[B], i), c = ld(p[C], i);
  const Fe k = sub(ld(p[D], j), x2(ld(p[D], i)));
  const Fe x_t = mul(k, ld(p[QL], i));
  const Fe y_t = add(mul(mul(k, k), sub(ld(p[QR], i), one)), one);
  Fe f = mul(mul(k, sub(k, one)), add(k, one));
  f = add(f, mul(sc(s, C_KF), sub(c, mul(k, ld(p[QC], i)))));
  const Fe dabc = mul(mul(sc(s, C_JD), a), mul(b, c));
  const Fe an = ld(p[A], j);
  const Fe f3 = sub(add(an, mul(an, dabc)), add(mul(a, y_t), mul(b, x_t)));
  f = add(f, mul(sc(s, S_KF2), f3));
  const Fe bn = ld(p[B], j);
  const Fe f4 = sub(sub(bn, mul(bn, dabc)), add(mul(b, y_t), mul(a, x_t)));
  f = add(f, mul(sc(s, S_KF3), f4));
  return mul(mul(sc(s, C_KF), ld(p[QFIXED], i)), f);
}

// kv q_vgadd (variable-base Edwards addition)
TERM vgadd_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  const Fe c = ld(p[C], i), d = ld(p[D], i);
  const Fe dn = ld(p[D], j);
  Fe v = sub(dn, mul(a, b));
  const Fe dp = mul(mul(sc(s, C_JD), dn), mul(c, d));
  const Fe an = ld(p[A], j);
  const Fe v2 = sub(add(an, mul(an, dp)), add(mul(a, d), mul(b, c)));
  v = add(v, mul(sc(s, C_KV), v2));
  const Fe bn = ld(p[B], j);
  const Fe v3 = sub(sub(bn, mul(bn, dp)), add(mul(b, d), mul(a, c)));
  v = add(v, mul(sc(s, S_KV2), v3));
  return mul(mul(sc(s, C_KV), ld(p[QVGADD], i)), v);
}

// (gate + alpha perm + alpha^2 L1 (z - 1)) Z_H^-1
TERM finish(const uint32_t* const* p, Scalars s, long long i, long long j,
            Fe gate) {
  const Fe beta = sc(s, C_BETA), gamma = sc(s, C_GAMMA);
  const Fe x = ld(p[XPTS], i);
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  const Fe c = ld(p[C], i), d = ld(p[D], i);
  Fe num = add(add(a, mul(beta, x)), gamma);
  num = mul(num, add(add(b, mul(sc(s, S_BK1), x)), gamma));
  num = mul(num, add(add(c, mul(sc(s, S_BK2), x)), gamma));
  num = mul(num, add(add(d, mul(sc(s, S_BK3), x)), gamma));
  const Fe z = ld(p[Z], i);
  Fe perm = mul(num, z);
  Fe den = add(add(a, mul(beta, ld(p[S1], i))), gamma);
  den = mul(den, add(add(b, mul(beta, ld(p[S2], i))), gamma));
  den = mul(den, add(add(c, mul(beta, ld(p[S3], i))), gamma));
  den = mul(den, add(add(d, mul(beta, ld(p[S4], i))), gamma));
  perm = sub(perm, mul(den, ld(p[Z], j)));
  Fe total = add(gate, mul(sc(s, C_ALPHA), perm));
  total = add(total, mul(sc(s, S_ALPHA2),
                         mul(ld(p[L1V], i), sub(z, sc(s, C_ONE)))));
  return mul(total, sc(s, C_ZH));
}

__global__ void __launch_bounds__(kThreads)
quotient_kernel(Inputs in, const uint32_t* __restrict__ table,
                uint32_t* __restrict__ out, long long n) {
  __shared__ uint32_t s[N_SC][8];
  __shared__ const uint32_t* p[N_IN];
  for (int k = threadIdx.x; k < N_COL * 8; k += blockDim.x)
    s[k / 8][k % 8] = table[k];
  if (threadIdx.x < N_IN) p[threadIdx.x] = in.p[threadIdx.x];
  __syncthreads();
  // derived scalars, one short chain per thread
  switch (threadIdx.x) {
    case 0: put(s, S_ALPHA2, mul(sc(s, C_ALPHA), sc(s, C_ALPHA))); break;
    case 1: {
      const Fe k2 = mul(sc(s, C_KR), sc(s, C_KR));
      put(s, S_KR2, k2);
      put(s, S_KR3, mul(k2, sc(s, C_KR)));
    } break;
    case 2: {
      const Fe k2 = mul(sc(s, C_KL), sc(s, C_KL));
      const Fe k3 = mul(k2, sc(s, C_KL));
      put(s, S_KL2, k2);
      put(s, S_KL3, k3);
      put(s, S_KL4, mul(k3, sc(s, C_KL)));
    } break;
    case 3: {
      const Fe k2 = mul(sc(s, C_KF), sc(s, C_KF));
      put(s, S_KF2, k2);
      put(s, S_KF3, mul(k2, sc(s, C_KF)));
    } break;
    case 4: put(s, S_KV2, mul(sc(s, C_KV), sc(s, C_KV))); break;
    case 5: put(s, S_BK1, mul(sc(s, C_BETA), sc(s, C_K1))); break;
    case 6: put(s, S_BK2, mul(sc(s, C_BETA), sc(s, C_K2))); break;
    case 7: put(s, S_BK3, mul(sc(s, C_BETA), sc(s, C_K3))); break;
    default: break;
  }
  __syncthreads();

  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long j = (i + 1 == n) ? 0 : i + 1;   // the next row
    Fe gate = arith_term(p, s, i);
    gate = add(gate, range_term(p, s, i, j));
    gate = add(gate, logic_term(p, s, i, j));
    gate = add(gate, fixed_term(p, s, i, j));
    gate = add(gate, vgadd_term(p, s, i, j));
    const Fe r = finish(p, s, i, j, gate);
    store_words<8>(out + i * 8, r.w);
  }
}

}  // namespace

// inputs: a host array of the N_IN device pointers, in In order
TPK_EXPORT int tpk_quotient_phase(const void* const* inputs,
                                  const void* table, void* out, long long n,
                                  void* stream) {
  Inputs in;
  for (int k = 0; k < N_IN; k++) in.p[k] = (const uint32_t*)inputs[k];
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  if (blocks < 1) blocks = 1;
  quotient_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      in, (const uint32_t*)table, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
