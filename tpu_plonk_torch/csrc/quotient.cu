// The quotient-phase body (replaces the TPU's fused Pallas kernel,
// tpu_plonk/proof_system/quotient_pallas.py _kernel / the pallas_call of
// _run_tiles_impl): at every point of one interleaved size-n coset s_i*H,
// the gate constraint (arith, range, logic, fixed-base and variable-base
// ECC widgets), the permutation term, the L1 term, all scaled by the
// phase's constant Z_H^-1.  The field ops are exact on canonical
// Montgomery values, so any algebraically equal order of operations
// gives the plain version's words (proof_system/quotient.py), bit for
// bit.
//
// One point per thread, grid-stride.  The next-row values a', b', d', z'
// are read here at row (j + 1) mod n, so no rolled copy of any input
// exists: 23 (n, 8) inputs in, one out.  The challenge constants arrive
// as a (15, 8) table in the reference's _COLS order less its k1..k3 rows
// (the k_j are the constants kK1..kK3 below); the block derives
// the powers it needs (kappa^2.., alpha^2, 2, 3) once into shared
// memory, so per point only products with a point-dependent operand
// remain.
//
// What bounds it on an H100: multiply issue.  The plain version does 107
// Fr multiplies a point; this kernel does 89
// (quotient.KERNEL_MULS_PER_POINT), 89 x 264 32-bit multiply
// instructions a point, ~0.37 ms at 2^18 against ~0.06 ms for its
// 24 x 32 bytes a point.  The parent kernel's SASS
// (scripts/torch_sass_mix.py) issued 30,673 instructions a point, 62%
// of them IMAD, with no local memory and 12 call/return instructions:
// the widget functions' calls cost nothing measurable, the multiplies
// are the work.  So the redesign cuts multiplies and keeps the shape:
//   - delta(v) = v (v-1) (v-2) (v-3) as t (t + 2) with t = v (v - 3):
//     2 products instead of 3, seven times a point;
//   - the logic gate's AND term as c (c83 + 3 sq - c27 sm + c (c27 +
//     c23 c - 3 sm)) with sq = sm^2 - 2 qa qb, and its g5 as
//     qd - and - qc (sm - 3 and): 19 products instead of 29;
//   - k (k - 1) (k + 1) as k (k^2 - 1), k^2 shared with y_t;
//   - beta k_j x for k_j = 7, 13, 17 (kK1..kK3) by doublings and
//     adds of beta x instead of three products;
//   - every input row as two 16-byte read-only loads (LDG.128) instead
//     of eight generic word loads.
// Each widget stays a function of its own, not inlined: only the running
// gate value lives across the calls, and ptxas allocates registers for
// six functions of ~15 multiplies each (one function of all of them
// inlined took ptxas about three minutes and spilled past 255
// registers).
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
  C_ZH, C_JD, C_C83, C_C27, C_C23, N_COL
};

// the permutation's wire-coset constants (params.K1..K3, which
// tests/test_torch_quotient.py holds equal to these): finish multiplies
// beta x by them with doublings and adds
constexpr int kK1 = 7, kK2 = 13, kK3 = 17;
// the block's shared scalars: the table rows plus derived values
enum Sc {
  S_ALPHA2 = N_COL, S_KR2, S_KR3, S_KL2, S_KL3, S_KL4, S_KF2, S_KF3, S_KV2,
  S_TWO, S_THREE, N_SC
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

// one input row: two read-only 16-byte loads (the rows are 32-byte
// aligned: the wrapper checks each input's address)
__device__ __forceinline__ Fe ld(const uint32_t* __restrict__ p,
                                 long long row) {
  const uint4* q = reinterpret_cast<const uint4*>(p + row * 8);
  const uint4 lo = __ldg(q), hi = __ldg(q + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

typedef uint32_t (*Scalars)[8];

__device__ __forceinline__ Fe sc(Scalars s, int k) {
  Fe r;
  load_words<8>(r.w, s[k]);
  return r;
}

// v (v - 1) (v - 2) (v - 3) = t (t + 2) with t = v (v - 3)
__device__ __forceinline__ Fe delta(const Fe& v, Scalars s) {
  const Fe t = mul(v, sub(v, sc(s, S_THREE)));
  return mul(t, add(t, sc(s, S_TWO)));
}

__device__ __forceinline__ void put(Scalars s, int k, const Fe& v) {
  store_words<8>(s[k], v.w);
}

// Each widget is a function of its own, not inlined (see the note at the
// top): it loads its inputs, computes its term and returns it.  `p` and
// `s` point to the block's shared copies of the input pointers and the
// scalars.
#define TERM __device__ __noinline__ Fe

// q_arith (q_m ab + q_l a + q_r b + q_4 d + q_o c + q_c) + pi: 7 products
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

// kr q_range (D(c-4d) + kr D(b-4c) + kr^2 D(a-4b) + kr^3 D(d'-4a)):
// 13 products
TERM range_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  const Fe c = ld(p[C], i), d = ld(p[D], i);
  Fe r = delta(sub(c, x4(d)), s);
  r = add(r, mul(sc(s, C_KR), delta(sub(b, x4(c)), s)));
  r = add(r, mul(sc(s, S_KR2), delta(sub(a, x4(b)), s)));
  r = add(r, mul(sc(s, S_KR3), delta(sub(ld(p[D], j), x4(a)), s)));
  return mul(mul(sc(s, C_KR), ld(p[QRANGE], i)), r);
}

// kl q_logic (2-bit quads, product wire on the current row's c): with
// sm = qa + qb, the reference's
//   and = c83 c + 3 c (qa^2 + qb^2) + c27 c^2 + c23 c^3
//         - c27 c sm - 3 c^2 sm
// as c (c83 + 3 sq - c27 sm + c (c27 + c23 c - 3 sm)), sq = sm^2 - 2 qa qb,
// and g5 = qd - (qc sm + (1 - 3 qc) and) as qd - and - qc (sm - 3 and):
// 19 products
TERM logic_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe c = ld(p[C], i);
  const Fe qa = sub(ld(p[A], j), x4(ld(p[A], i)));
  const Fe qb = sub(ld(p[B], j), x4(ld(p[B], i)));
  const Fe qd = sub(ld(p[D], j), x4(ld(p[D], i)));
  Fe g = delta(qa, s);
  g = add(g, mul(sc(s, C_KL), delta(qb, s)));
  g = add(g, mul(sc(s, S_KL2), delta(qd, s)));
  const Fe ab = mul(qa, qb);
  g = add(g, mul(sc(s, S_KL3), sub(c, ab)));
  const Fe sm = add(qa, qb);
  const Fe sq = sub(mul(sm, sm), x2(ab));
  Fe u = sub(add(sc(s, C_C27), mul(sc(s, C_C23), c)), x3(sm));
  u = add(sub(add(sc(s, C_C83), x3(sq)), mul(sc(s, C_C27), sm)),
          mul(c, u));
  const Fe andv = mul(c, u);
  const Fe g5 = sub(sub(qd, andv), mul(ld(p[QC], i), sub(sm, x3(andv))));
  g = add(g, mul(sc(s, S_KL4), g5));
  return mul(mul(sc(s, C_KL), ld(p[QLOGIC], i)), g);
}

// kf q_fixed (fixed-base ECC ladder row); k (k - 1) (k + 1) as
// k (k^2 - 1): 19 products
TERM fixed_term(const uint32_t* const* p, Scalars s, long long i,
                long long j) {
  const Fe one = sc(s, C_ONE);
  const Fe a = ld(p[A], i), b = ld(p[B], i), c = ld(p[C], i);
  const Fe k = sub(ld(p[D], j), x2(ld(p[D], i)));
  const Fe k2 = mul(k, k);
  const Fe x_t = mul(k, ld(p[QL], i));
  const Fe y_t = add(mul(k2, sub(ld(p[QR], i), one)), one);
  Fe f = mul(k, sub(k2, one));
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

// kv q_vgadd (variable-base Edwards addition): 14 products
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

// (gate + alpha perm + alpha^2 L1 (z - 1)) Z_H^-1; beta k_j x for
// k_j = 7, 13, 17 from beta x by doublings and adds: 17 products
TERM finish(const uint32_t* const* p, Scalars s, long long i, long long j,
            Fe gate) {
  static_assert(kK1 == 8 - 1 && kK2 == 8 + 4 + 1 && kK3 == 16 + 1,
                "the add chains below are written for these k_j");
  const Fe beta = sc(s, C_BETA), gamma = sc(s, C_GAMMA);
  const Fe a = ld(p[A], i), b = ld(p[B], i);
  const Fe c = ld(p[C], i), d = ld(p[D], i);
  const Fe bx = mul(beta, ld(p[XPTS], i));
  const Fe bx4 = x4(bx), bx8 = x2(bx4);
  Fe num = add(add(a, bx), gamma);
  num = mul(num, add(add(b, sub(bx8, bx)), gamma));             // 7
  num = mul(num, add(add(c, add(add(bx8, bx4), bx)), gamma));   // 13
  num = mul(num, add(add(d, add(x2(bx8), bx)), gamma));         // 17
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
    case 5: {
      const Fe two = x2(sc(s, C_ONE));
      put(s, S_TWO, two);
      put(s, S_THREE, add(two, sc(s, C_ONE)));
    } break;
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

// inputs: a host array of the N_IN device pointers, in In order, each
// 16-byte aligned
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
