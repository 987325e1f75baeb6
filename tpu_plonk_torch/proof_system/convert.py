"""Carry preprocessed state from the reference JAX package into the
port.  Everything crosses as numpy arrays in the reference's device
layout, so this module imports nothing of the reference:

  * ProverKey tables: (n, 16) Montgomery-form 16-bit limbs (what the
    reference's engine_device.to_dev / preprocess_device produce);
  * the SRS: the reference's packed (N+1, 3, 24) projective Montgomery
    table (msm_csr.pack_points: row 0 the identity pad, rows 1.. affine
    with z = R), or host affine points.

Port tensors are (n, 8) / (N, 2, 12) int32 words on `device`.
"""

import numpy as np

from ..fields import device as dev
from ..poly.domain import Domain
from ..cs.composer import SELECTOR_NAMES
from ..kernels import resolve_device
from .preprocess import ProverKey

_FP_ONE16 = np.frombuffer(((1 << 384) % dev.FP.modulus).to_bytes(48, "little"),
                          dtype="<u2").astype(np.uint32)


def prover_key_from_arrays(n: int, selector_coeffs: dict, sigma_coeffs,
                           wire_vars: dict, device=None) -> ProverKey:
    """ProverKey with the port's tensors from (n, 16) limb arrays
    (selector name -> array, 4 sigma arrays) and the padded wire index
    table."""
    dv = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.shape != (n, 16):
            raise ValueError(f"expected ({n}, 16) limbs, got {a.shape}")
        return dev.limbs16_to_words(a).to(dv)

    sel = {name: conv(selector_coeffs[name]) for name in SELECTOR_NAMES}
    sig = [conv(s) for s in sigma_coeffs]
    wires = {w: list(map(int, wire_vars[w])) for w in "abcd"}
    return ProverKey(n, Domain(n), Domain(4 * n), sel, None, sig, None,
                     wires, None, None, None)


def prover_key_to_arrays(pk):
    """The inverse: ({name: (n, 16) uint32}, [4 x (n, 16) uint32])."""
    sel = {name: dev.words_to_limbs16(pk.selector_coeffs[name])
           for name in SELECTOR_NAMES}
    return sel, [dev.words_to_limbs16(s) for s in pk.sigma_coeffs]


def srs_from_packed(packed, device=None):
    """The reference's packed (N+1, 3, 24) SRS table -> the port's
    (N, 2, 12) affine table (row 0, the identity pad, dropped)."""
    dv = resolve_device(device)
    packed = np.asarray(packed)
    if packed.ndim != 3 or packed.shape[1:] != (3, 24):
        raise ValueError(f"expected (N+1, 3, 24) limbs, got {packed.shape}")
    pts = packed[1:]
    if not (pts[:, 2, :] == _FP_ONE16[None]).all():
        raise ValueError("packed SRS rows 1.. must be affine (z == R)")
    return dev.limbs16_to_words(pts[:, :2, :]).to(dv)
