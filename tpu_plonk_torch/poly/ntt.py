"""NTT / iNTT over Fr on torch tensors (mirrors tpu_plonk/poly/ntt.py).

Layout: (..., n, 8) int32 Montgomery words, natural order in and out,
canonical.  One route at every size: on a CUDA tensor the kernel of
csrc/ntt.cu, the radix-2 schedule cut into `pass_plan(log_n)` passes of
shared-memory tiles (one launch a pass, the bit reversal and pre-scale
folded into the first, the inverse's output scale into the last), on a
CPU tensor the plain version below (the same radix-2 schedule, stage by
stage, in batched torch ops).  The kernel takes over both TPU kernels
of the reference's MXU route, the digit pipeline of each DFT level and
the four-step twiddle boundary (tpu_plonk/poly/ntt_mxu_pl.py).

`ntt_many(xs, log_n, inverse, scale)` keeps the reference's coset
semantics (ntt.py:264-293): forward computes the transform of
x[j] * scale^j (evaluations on the coset scale*H); inverse scales output
coefficient j by scale^j (pass scale = s^-1 to undo a coset).
"""

import ctypes
import functools

import torch

from ..params import R_MOD
from ..fields import device as dev
from .. import kernels as K
from .domain import Domain

FR = dev.FR

_NTT = K.Kernel("ntt", "tpk_ntt", [K.P, K.P, K.P, K.P, K.P, K.I32, K.I64,
                                    K.P, K.I32])

#: the most butterfly stages one pass of the kernel runs (a tile of 2^10
#: elements and its twiddles, 64 KB of shared memory)
MAX_TILE_LOG = 10


def pass_plan(log_n: int) -> list:
    """The kernel's passes: stages per pass, as even as possible, each at
    most MAX_TILE_LOG, summing to log_n (2^18: [9, 9]; 2^22: [8, 7, 7])."""
    passes = -(-log_n // MAX_TILE_LOG)
    k, extra = divmod(log_n, passes)
    return [k + 1] * extra + [k] * (passes - extra)


@functools.lru_cache(maxsize=64)
def _powers(base: int, count: int, device: str, plain: bool):
    """(count, 8) Montgomery powers base^j on `device`; with plain=True
    built by the plain multiply, so the plain transform uses no kernel."""
    if not plain:
        return dev.powers_of(FR.const(base, device), count, FR)
    x = FR.const(base, device).expand(count, 8).clone()
    x[0] = FR.const(1, device)[0]
    return dev.scan(x, lambda a, b: dev.mont_mul_plain(a, b, FR))


@functools.lru_cache(maxsize=64)
def _post_scale(scale: int, log_n: int, device: str, plain: bool):
    """n^-1 * scale^j: the inverse transform's output factors."""
    mul = dev.mont_mul_plain if plain else dev.mont_mul
    n = 1 << log_n
    return mul(_powers(scale, n, device, plain),
               FR.const(Domain(n).n_inv, device), FR)


def _twiddles(log_n: int, inverse: bool, device: str, plain: bool):
    dom = Domain(1 << log_n)
    w = dom.omega_inv if inverse else dom.omega
    return _powers(w, max(1, (1 << log_n) // 2), device, plain)


@functools.lru_cache(maxsize=None)
def _bitrev(log_n: int, device: str) -> torch.Tensor:
    i = torch.arange(1 << log_n)
    r = torch.zeros_like(i)
    for b in range(log_n):
        r |= ((i >> b) & 1) << (log_n - 1 - b)
    return r.to(device)


def _transform_plain(x, log_n: int, tw, pre):
    """Plain radix-2 DIT: optional pre-scale, bit-reversal gather,
    log2(n) butterfly stages (x: (B, n, 8))."""
    B, n = x.shape[0], 1 << log_n
    if pre is not None:
        x = dev.mont_mul_plain(x, pre, FR)
    y = x[:, _bitrev(log_n, str(x.device))]
    for s in range(log_n):
        h = 1 << s
        yr = y.reshape(B, n // (2 * h), 2, h, 8)
        w = tw[:: n // (2 * h)][:h]
        v = dev.mont_mul_plain(yr[:, :, 1], w, FR)
        u = yr[:, :, 0]
        y = torch.stack([dev.add_mod_plain(u, v, FR),
                         dev.sub_mod_plain(u, v, FR)], dim=2).reshape(B, n, 8)
    return y


def _transform_kernel(x, log_n: int, tw, pre, post):
    """The whole transform of (B, n, 8) by the CUDA kernel: one launch a
    pass of `pass_plan(log_n)`, pre before it and post after it."""
    x = x.contiguous()
    K.check_words(x, 8, "ntt input")
    if x.dim() != 3 or x.shape[1] != (1 << log_n):
        raise ValueError(f"ntt: expected (B, 2^{log_n}, 8), got "
                         f"{tuple(x.shape)}")
    if log_n < 1:
        raise ValueError("ntt: log_n must be >= 1")
    if x.data_ptr() % 16:
        raise ValueError("ntt input: the kernel loads 16 bytes at a time; "
                         "the tensor must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.shape[0]:
        plan = pass_plan(log_n)
        stages = (ctypes.c_int * len(plan))(*plan)
        _NTT(x.data_ptr(), out.data_ptr(),
             None if pre is None else pre.data_ptr(),
             None if post is None else post.data_ptr(), tw.data_ptr(),
             log_n, x.shape[0], ctypes.addressof(stages), len(plan))
    return out


def _many(xs, log_n: int, inverse: bool, scale: int, plain: bool):
    scale %= R_MOD
    d = str(xs.device)
    plain = plain or xs.device.type != "cuda"
    tw = _twiddles(log_n, inverse, d, plain)
    pre = post = None
    if not inverse and scale != 1:
        pre = _powers(scale, 1 << log_n, d, plain)
    if inverse:
        post = _post_scale(scale, log_n, d, plain)
    if not plain:
        return _transform_kernel(xs, log_n, tw, pre, post)
    y = _transform_plain(xs, log_n, tw, pre)
    return y if post is None else dev.mont_mul_plain(y, post, FR)


def transform_plain(xs, log_n: int, inverse: bool = False, scale: int = 1):
    """Plain version of `ntt_many` (any device, no kernel)."""
    return _many(xs, log_n, inverse, scale, plain=True)


def ntt_many(xs, log_n: int, inverse: bool = False, scale: int = 1):
    """Batched transform of independent polynomials (B, n, 8) ->
    (B, n, 8); see the module docstring for `scale`."""
    return _many(xs, log_n, inverse, scale, plain=False)


def ntt(x, log_n: int):
    """Forward NTT: coefficients -> evaluations over H."""
    return ntt_many(x[None], log_n)[0]


def intt(x, log_n: int):
    """Inverse NTT: evaluations over H -> coefficients."""
    return ntt_many(x[None], log_n, inverse=True)[0]


def coset_ntt(x, log_n: int):
    """Evaluations of the coefficient vector over the coset g*H."""
    return ntt_many(x[None], log_n, scale=Domain(1 << log_n).coset_gen)[0]


def coset_intt(x, log_n: int):
    g_inv = pow(Domain(1 << log_n).coset_gen, -1, R_MOD)
    return ntt_many(x[None], log_n, inverse=True, scale=g_inv)[0]
