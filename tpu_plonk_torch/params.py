"""Global curve / field parameters for the TPU PLONK stack.

Single source of truth for every numerical constant in the framework:
BLS12-381 base and scalar fields, the G1/G2 groups, the JubJub embedded
curve, NTT two-adic roots, Montgomery parameters for the device limb
representation, and the permutation-argument coset constants.

Reference parity notes (SURVEY.md §2.4-2.5):
  - Fr is `dusk_bls12_381::BlsScalar` (Cargo.toml:20 of the reference);
    canonical serialization is 32-byte little-endian (dusk-bytes
    `Serializable`, reference src/zk/gadgets.rs:20,230).
  - JubJub generators GENERATOR / GENERATOR_NUMS mirror dusk-jubjub 0.10
    (used at reference src/zk/gadgets.rs:21).  Both are validated
    on-curve + in-subgroup by tests/test_curves.py.
  - K1/K2/K3 are the wire-coset constants of the permutation argument
    (dusk-plonk style: 7, 13, 17).
"""

# ---------------------------------------------------------------------------
# BLS12-381 scalar field Fr (the circuit field)
# ---------------------------------------------------------------------------

#: Fr modulus ("q" in dusk-plonk docs; order of G1/G2 subgroups).
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

#: Fr multiplicative-group generator (smallest: 7). Also the coset
#: generator used for extended-domain (coset) FFTs.
FR_GENERATOR = 7

#: Two-adicity of Fr: r - 1 = 2^32 * T_ODD.
TWO_ADICITY = 32
T_ODD = (R_MOD - 1) >> TWO_ADICITY
assert T_ODD % 2 == 1

#: 2^32-th primitive root of unity: 7^T_ODD mod r.
ROOT_OF_UNITY = pow(FR_GENERATOR, T_ODD, R_MOD)

# ---------------------------------------------------------------------------
# BLS12-381 base field Fp and curve constants
# ---------------------------------------------------------------------------

#: Fp modulus.
P_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

#: Curve equation y^2 = x^3 + 4 over Fp (G1); y^2 = x^3 + 4(u+1) over Fp2 (G2).
B_G1 = 4

#: BLS parameter x (z in some papers); the curve is generated with x < 0.
BLS_X = 0xD201000000010000
BLS_X_IS_NEG = True

#: G1 generator (standard, as in zkcrypto / dusk-bls12_381).
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

#: G2 generator (Fp2 coordinates as (c0, c1)).
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# ---------------------------------------------------------------------------
# JubJub (embedded twisted Edwards curve over Fr):  -x^2 + y^2 = 1 + d x^2 y^2
# ---------------------------------------------------------------------------

#: Edwards `a` coefficient (-1) and `d = -(10240/10241) mod r`.
JUBJUB_A = R_MOD - 1
JUBJUB_D = (-(10240 * pow(10241, -1, R_MOD))) % R_MOD

#: Order of the prime-order subgroup of JubJub; cofactor 8.
JUBJUB_ORDER = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
JUBJUB_COFACTOR = 8

#: dusk-jubjub 0.10 `GENERATOR` (used by the reference's Pedersen /
#: ownership gadgets, src/zk/gadgets.rs:21).  Validated on-curve by tests;
#: if fixture pinning later disagrees, update here (single point of truth).
JUBJUB_GENERATOR_X = 0x3FD2814C43AC65A6F1FBF02D0FD6CCE62E3EBB21FD6C54ED4DF7B7FFEC7BEACA
JUBJUB_GENERATOR_Y = 0x0000000000000000000000000000000000000000000000000000000000000012

#: dusk-jubjub 0.10 `GENERATOR_NUMS` ("nothing-up-my-sleeve" second
#: generator for Pedersen blinding).  Validated on-curve by tests.
JUBJUB_GENERATOR_NUMS_X = 0x5E67B8F316F414F7BD9514C773FD4456931E316A39FE4541921710179DF76377
JUBJUB_GENERATOR_NUMS_Y = 0x43D80EB3B2F3EB1B7B162DBEEB3B34FD9949BA0F82A5507A6705B707162E3EF8

# ---------------------------------------------------------------------------
# Device limb representation (see fields/limbs.py)
# ---------------------------------------------------------------------------

#: 16-bit limbs: products of two limbs fit exactly in uint32 (TPU has no
#: 64-bit integer multiply; 16x16->32 is exact in one u32 mult).
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

#: Fr: 256 bits -> 16 limbs.  Montgomery radix R = 2^256.
FR_LIMBS = 16
FR_MONT_R = 1 << (LIMB_BITS * FR_LIMBS)
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MOD
#: -r^{-1} mod 2^256 (for separated REDC) and mod 2^16 (for CIOS).
FR_NEG_INV = (-pow(R_MOD, -1, FR_MONT_R)) % FR_MONT_R
FR_NEG_INV_LIMB = FR_NEG_INV & LIMB_MASK

#: Fp: 384 bits -> 24 limbs.  Montgomery radix 2^384.
FP_LIMBS = 24
FP_MONT_R = 1 << (LIMB_BITS * FP_LIMBS)
FP_MONT_R2 = (FP_MONT_R * FP_MONT_R) % P_MOD
FP_NEG_INV = (-pow(P_MOD, -1, FP_MONT_R)) % FP_MONT_R
FP_NEG_INV_LIMB = FP_NEG_INV & LIMB_MASK

# ---------------------------------------------------------------------------
# PLONK permutation-argument coset constants (4 wire columns).
# Column identity polynomials are  k_j * X  with k in (1, K1, K2, K3);
# K1/K2/K3 must not lie in each other's cosets of H (7, 13, 17 -- the
# dusk-plonk constants, SURVEY.md §2.7).  csrc/quotient.cu holds them as
# kK1..kK3 and multiplies by them with add chains written for 7, 13, 17
# (tests/test_torch_quotient.py holds the two equal).
# ---------------------------------------------------------------------------

K1 = 7
K2 = 13
K3 = 17
