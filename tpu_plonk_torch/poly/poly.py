"""Host-side dense polynomial helpers over Fr (coefficient vectors as
python-int lists, lowest degree first).  Mirrors dusk-plonk's
`fft::Polynomial` surface (SURVEY.md §2.6): arithmetic, evaluation,
and Ruffini (synthetic) division for KZG openings."""

from ..params import R_MOD
from ..fields import fr


def trim(p):
    i = len(p)
    while i > 0 and p[i - 1] % R_MOD == 0:
        i -= 1
    return [c % R_MOD for c in p[:i]]


def add(p, q):
    n = max(len(p), len(q))
    return [((p[i] if i < len(p) else 0) + (q[i] if i < len(q) else 0)) % R_MOD
            for i in range(n)]


def sub(p, q):
    n = max(len(p), len(q))
    return [((p[i] if i < len(p) else 0) - (q[i] if i < len(q) else 0)) % R_MOD
            for i in range(n)]


def scale(p, k):
    k %= R_MOD
    return [c * k % R_MOD for c in p]


def mul(p, q):
    if not p or not q:
        return []
    out = [0] * (len(p) + len(q) - 1)
    for i, a in enumerate(p):
        if a == 0:
            continue
        for j, b in enumerate(q):
            out[i + j] = (out[i + j] + a * b) % R_MOD
    return out


def mul_fft(p, q):
    """Product via NTT over a large-enough domain (the dusk
    `Polynomial` multiply path, SURVEY.md §2.6); falls back to
    schoolbook below the crossover."""
    if not p or not q:
        return []
    out_len = len(p) + len(q) - 1
    if out_len <= 64:
        return mul(p, q)
    from .domain import Domain
    size = 1
    while size < out_len:
        size <<= 1
    d = Domain(size)
    pe = d.ntt(list(p))
    qe = d.ntt(list(q))
    prod = [a * b % R_MOD for a, b in zip(pe, qe)]
    return trim(d.intt(prod))[:out_len]


def evaluate(p, x: int) -> int:
    acc = 0
    for c in reversed(p):
        acc = (acc * x + c) % R_MOD
    return acc


def ruffini(p, z: int):
    """Divide p(X) by (X - z); p(z) must be 0.  Returns the quotient."""
    out = [0] * (len(p) - 1) if len(p) > 1 else []
    acc = 0
    for i in range(len(p) - 1, 0, -1):
        acc = (acc * z + p[i]) % R_MOD
        out[i - 1] = acc
    assert (acc * z + (p[0] if p else 0)) % R_MOD == 0, \
        "ruffini: p(z) != 0"
    return out
