"""Host <-> device conversions for the multi-limb field representation.

Device representation (SURVEY.md §7 step 1): base-2^16 limbs in uint32,
little-endian limb order, last axis of the array.  16-bit limbs are the
TPU-native choice — a 16x16 product is exact in one u32 multiply (TPU has
no 64-bit integer multiply), and Comba column sums of <=24 terms stay
far below 2^32.
"""

import numpy as np

from ..params import LIMB_BITS, LIMB_MASK, FR_LIMBS, FP_LIMBS, R_MOD, P_MOD


def int_to_limbs(value: int, n_limbs: int) -> np.ndarray:
    return np.array(
        [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)],
        dtype=np.uint32,
    )


def ints_to_limbs(values, n_limbs: int) -> np.ndarray:
    """Vectorized conversion of a list of ints -> (len, n_limbs) uint32."""
    nbytes = n_limbs * LIMB_BITS // 8
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs)
    return u16.astype(np.uint32)


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.uint64)
    return sum(int(l) << (LIMB_BITS * i) for i, l in enumerate(limbs))


def limbs_to_ints(arr) -> list:
    arr = np.asarray(arr)
    *batch, n_limbs = arr.shape
    flat = arr.reshape(-1, n_limbs).astype("<u2")
    nbytes = n_limbs * 2
    raw = flat.tobytes()
    return [
        int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little")
        for i in range(flat.shape[0])
    ]


def fr_to_limbs(values) -> np.ndarray:
    return ints_to_limbs([v % R_MOD for v in values], FR_LIMBS)


def fp_to_limbs(values) -> np.ndarray:
    return ints_to_limbs([v % P_MOD for v in values], FP_LIMBS)
