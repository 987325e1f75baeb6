"""Four-step (Bailey) NTT sharded over the mesh (mirrors
tpu_plonk/dist/ntt_sharded.py).

N = R*C, viewed as A[n2][n1] = x[n1 + C*n2]: the natural block sharding
of x is the block-row sharding of A.  Then

  transpose -> local NTT_R on rows -> twiddle w_N^(n1*k2)
  -> transpose -> local NTT_C on rows -> transpose -> natural order.

Each transpose is one `all_to_all_single` and a local permute; each
local transform is the port's batched `ntt_many` (the `ntt` kernel on a
CUDA tensor); the twiddle and the coset scale are Fr multiplies
(`fr_mont_mul`).  The inverse runs the same steps with w^-1, and the two
local inverses' 1/R and 1/C make 1/N.  The result is the same words as
the single-device transform, on every rank count.
"""

import functools

from ..params import R_MOD
from ..fields import device as dev
from ..poly import ntt as nttmod
from ..poly.domain import Domain
from . import multihost
from .mesh import Mesh

FR = dev.FR


def split(log_n: int, size: int) -> int:
    """log2 R of the four-step's N = R*C: about half of log_n, raised
    until the rank count divides R; both R and C must divide by it."""
    log_r = log_n // 2
    while (1 << log_r) % size and log_r < log_n:
        log_r += 1
    r, c = 1 << log_r, 1 << (log_n - log_r)
    if r % size or c % size:
        raise ValueError(f"{size} ranks do not divide both factors of "
                         f"2^{log_n} = {r} x {c}")
    return log_r


@functools.lru_cache(maxsize=16)
def _twiddles(log_n: int, log_r: int, inverse: bool, rank: int, size: int,
              device: str):
    """(C/D, R, 8) Montgomery twiddles w_N^(n1*k2) (w^-1 for the inverse)
    for this rank's block of n1: one power ladder per row, built by a
    scan along k2."""
    dom = Domain(1 << log_n)
    w = dom.omega_inv if inverse else dom.omega
    r, cd = 1 << log_r, (1 << (log_n - log_r)) // size
    bases = [pow(w, rank * cd + i, R_MOD) for i in range(cd)]
    ladder = dev.ints_to_words(bases, FR, device, mont=True)[None].expand(
        r, cd, FR.n_words).clone()
    ladder[0] = FR.const(1, device)
    return dev.prefix_mul_mont(ladder, FR).transpose(0, 1).contiguous()


@functools.lru_cache(maxsize=16)
def _block_powers(scale: int, log_n: int, rank: int, size: int, device: str):
    """scale^j for j in this rank's row block of 2^log_n, (n/D, 8)."""
    m = (1 << log_n) // size
    lead = FR.const(pow(scale, rank * m, R_MOD), device)
    return dev.mont_mul(dev.powers_of(FR.const(scale, device), m, FR), lead,
                        FR)


def _transpose(mesh: Mesh, a):
    """(B, A/D, K, 8) row blocks of B matrices (A x K) -> (B, K/D, A, 8):
    this rank's block of rows of each transpose."""
    b, ad, k, w = a.shape
    d = mesh.size
    chunks = a.reshape(b, ad, d, k // d, w).permute(2, 0, 1, 3, 4)
    got = multihost.all_to_all(mesh, chunks)        # (D, B, A/D, K/D, 8)
    return got.permute(1, 3, 0, 2, 4).reshape(b, k // d, d * ad, w)


def ntt_sharded(mesh: Mesh, x, log_n: int, inverse: bool = False,
                scale: int = 1):
    """This rank's row block (n/D, 8), or a batch (B, n/D, 8), of
    natural-order vectors -> its block of their transforms, with
    `ntt_many`'s semantics: forward evaluates over the coset scale*H
    (the transform of x[j] scale^j), inverse scales output coefficient j
    by scale^j."""
    single = x.dim() == 2
    if single:
        x = x[None]
    n, d = 1 << log_n, mesh.size
    if x.shape[1:] != (n // d, FR.n_words):
        raise ValueError(f"ntt_sharded: expected (B, 2^{log_n}/{d}, 8), got "
                         f"{tuple(x.shape)}")
    if x.device != mesh.device:
        raise ValueError(f"ntt_sharded: input on {x.device}, the mesh "
                         f"rank on {mesh.device}")
    scale %= R_MOD
    dv = str(x.device)
    log_r = split(log_n, d)
    log_c = log_n - log_r
    r, c, b = 1 << log_r, 1 << log_c, x.shape[0]
    if not inverse and scale != 1:
        x = dev.mont_mul(x, _block_powers(scale, log_n, mesh.rank, d, dv), FR)
    at = _transpose(mesh, x.reshape(b, r // d, c, FR.n_words))
    bt = nttmod.ntt_many(at.reshape(-1, r, FR.n_words), log_r, inverse)
    bt = dev.mont_mul(bt.reshape(b, c // d, r, FR.n_words),
                      _twiddles(log_n, log_r, inverse, mesh.rank, d, dv), FR)
    bb = _transpose(mesh, bt)
    cc = nttmod.ntt_many(bb.reshape(-1, c, FR.n_words), log_c, inverse)
    out = _transpose(mesh, cc.reshape(b, r // d, c, FR.n_words))
    out = out.reshape(b, n // d, FR.n_words)
    if inverse and scale != 1:
        out = dev.mont_mul(out, _block_powers(scale, log_n, mesh.rank, d, dv),
                           FR)
    return out[0] if single else out


def ntt_replicated(mesh: Mesh, xs, log_n: int, inverse: bool = False,
                   scale: int = 1):
    """The sharded transform of vectors every rank holds whole, (B, n, 8):
    each rank transforms its row block, and the blocks are gathered back
    whole on every rank.  The mesh prove's rounds call this."""
    local = multihost.global_put(mesh, xs, dim=1)
    return multihost.allgather(
        mesh, ntt_sharded(mesh, local, log_n, inverse, scale), dim=1)


def coset_ntt_sharded(mesh: Mesh, x, log_n: int):
    """Evaluations over the coset g*H (poly/ntt.py coset_ntt), sharded."""
    return ntt_sharded(mesh, x, log_n, scale=Domain(1 << log_n).coset_gen)


def coset_intt_sharded(mesh: Mesh, x, log_n: int):
    g_inv = pow(Domain(1 << log_n).coset_gen, -1, R_MOD)
    return ntt_sharded(mesh, x, log_n, inverse=True, scale=g_inv)
