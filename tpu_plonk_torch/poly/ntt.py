"""NTT / iNTT over Fr on torch tensors (mirrors tpu_plonk/poly/ntt.py).

Layout: (..., n, 8) int32 Montgomery words, natural order in and out,
canonical.  One route at every size: on a CUDA tensor the radix-2
kernel of csrc/ntt.cu (bit-reversal gather + log2(n) butterfly stages),
on a CPU tensor the plain version below (the same radix-2 schedule in
batched torch ops).  The kernel takes over both TPU kernels of the
reference's MXU route, the digit pipeline of each DFT level and the
four-step twiddle boundary (tpu_plonk/poly/ntt_mxu_pl.py).

`ntt_many(xs, log_n, inverse, scale)` keeps the reference's coset
semantics (ntt.py:264-293): forward computes the transform of
x[j] * scale^j (evaluations on the coset scale*H); inverse scales output
coefficient j by scale^j (pass scale = s^-1 to undo a coset).
"""

import functools

import torch

from ..params import R_MOD
from ..fields import device as dev
from .. import kernels as K
from .domain import Domain

FR = dev.FR

_NTT = K.Kernel("ntt", "tpk_ntt", [K.P, K.P, K.P, K.P, K.I32, K.I64])


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


def _transform_kernel(x, log_n: int, tw, pre):
    """Bit-reversal + stages on (B, n, 8) by the CUDA kernel."""
    x = x.contiguous()
    K.check_words(x, 8, "ntt input")
    if x.dim() != 3 or x.shape[1] != (1 << log_n):
        raise ValueError(f"ntt: expected (B, 2^{log_n}, 8), got "
                         f"{tuple(x.shape)}")
    if log_n < 1:
        raise ValueError("ntt: log_n must be >= 1")
    out = torch.empty_like(x)
    if x.shape[0]:
        _NTT(x.data_ptr(), out.data_ptr(),
             None if pre is None else pre.data_ptr(), tw.data_ptr(),
             log_n, x.shape[0])
    return out


def _many(xs, log_n: int, inverse: bool, scale: int, plain: bool):
    scale %= R_MOD
    d = str(xs.device)
    plain = plain or xs.device.type != "cuda"
    tw = _twiddles(log_n, inverse, d, plain)
    pre = None
    if not inverse and scale != 1:
        pre = _powers(scale, 1 << log_n, d, plain)
    run = _transform_plain if plain else _transform_kernel
    y = run(xs, log_n, tw, pre)
    if not inverse:
        return y
    mul = dev.mont_mul_plain if plain else dev.mont_mul
    return mul(y, _post_scale(scale, log_n, d, plain), FR)


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
