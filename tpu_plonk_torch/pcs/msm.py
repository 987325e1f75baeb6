"""Host multi-scalar multiplication (Pippenger) over G1 in Jacobian
coordinates — the correctness oracle and small-size path; the TPU
device MSM lives in pcs/msm_csr.py (SURVEY.md §2.10).
"""

from ..params import P_MOD, R_MOD

# Jacobian point: (X, Y, Z) with x = X/Z^2, y = Y/Z^3; infinity: Z = 0.
J_INF = (1, 1, 0)


def jac_from_affine(p):
    if p is None:
        return J_INF
    return (p[0], p[1], 1)


def jac_to_affine(p):
    x, y, z = p
    if z == 0:
        return None
    zi = pow(z, -1, P_MOD)
    zi2 = zi * zi % P_MOD
    return (x * zi2 % P_MOD, y * zi2 % P_MOD * zi % P_MOD)


def jac_double(p):
    x, y, z = p
    if z == 0 or y == 0:
        return J_INF if z == 0 else _jac_double_nonzero(p)
    return _jac_double_nonzero(p)


def _jac_double_nonzero(p):
    x, y, z = p
    a = x * x % P_MOD
    b = y * y % P_MOD
    c = b * b % P_MOD
    d = 2 * ((x + b) * (x + b) - a - c) % P_MOD
    e = 3 * a % P_MOD
    f = e * e % P_MOD
    x3 = (f - 2 * d) % P_MOD
    y3 = (e * (d - x3) - 8 * c) % P_MOD
    z3 = 2 * y * z % P_MOD
    return (x3, y3, z3)


def jac_add(p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    if z1 == 0:
        return q
    if z2 == 0:
        return p
    z1z1 = z1 * z1 % P_MOD
    z2z2 = z2 * z2 % P_MOD
    u1 = x1 * z2z2 % P_MOD
    u2 = x2 * z1z1 % P_MOD
    s1 = y1 * z2 % P_MOD * z2z2 % P_MOD
    s2 = y2 * z1 % P_MOD * z1z1 % P_MOD
    if u1 == u2:
        if s1 != s2:
            return J_INF
        return _jac_double_nonzero(p)
    h = (u2 - u1) % P_MOD
    i = 4 * h * h % P_MOD
    j = h * i % P_MOD
    r = 2 * (s2 - s1) % P_MOD
    v = u1 * i % P_MOD
    x3 = (r * r - j - 2 * v) % P_MOD
    y3 = (r * (v - x3) - 2 * s1 * j) % P_MOD
    z3 = ((z1 + z2) * (z1 + z2) - z1z1 - z2z2) % P_MOD * h % P_MOD
    return (x3, y3, z3)


def jac_neg(p):
    return (p[0], (-p[1]) % P_MOD, p[2])


def _wnaf(k: int, w: int):
    """Width-w NAF digits (LSB first): odd digits in (-2^(w-1), 2^(w-1))."""
    out = []
    while k:
        if k & 1:
            d = k & ((1 << w) - 1)
            if d >= (1 << (w - 1)):
                d -= 1 << w
            k -= d
        else:
            d = 0
        out.append(d)
        k >>= 1
    return out


def msm_jac(pairs, w: int = 5):
    """Straus/wNAF multi-scalar sum for SMALL point sets (the verifier's
    ~20-point linearization/fold MSMs — VERDICT round-1 task 10): shared
    doubling chain, per-point odd-multiple tables, ~255/(w+1) adds per
    point.  Affine-or-None points in, Jacobian out."""
    tables = []
    nafs = []
    for p, s in pairs:
        s = s % R_MOD
        if p is None or s == 0:
            continue
        base = jac_from_affine(p)
        twice = _jac_double_nonzero(base)
        tbl = [base]  # odd multiples 1P, 3P, ..., (2^(w-1)-1)P
        for _ in range((1 << (w - 2)) - 1):
            tbl.append(jac_add(tbl[-1], twice))
        tables.append(tbl)
        nafs.append(_wnaf(s, w))
    if not tables:
        return J_INF
    top = max(len(n) for n in nafs)
    acc = J_INF
    for i in range(top - 1, -1, -1):
        acc = jac_double(acc)
        for tbl, naf in zip(tables, nafs):
            if i < len(naf) and naf[i]:
                d = naf[i]
                q = tbl[abs(d) >> 1]
                acc = jac_add(acc, q if d > 0 else jac_neg(q))
    return acc


def msm_small(pairs, w: int = 5):
    """Affine-out wrapper over msm_jac (pure Python)."""
    return jac_to_affine(msm_jac(pairs, w))


def msm(points, scalars, window_bits: int = 8):
    """Pippenger: sum scalars[i] * points[i] (affine in, affine out)."""
    assert len(points) == len(scalars)
    pts = [jac_from_affine(p) for p in points]
    sc = [s % R_MOD for s in scalars]
    n_windows = (255 + window_bits - 1) // window_bits
    acc = J_INF
    for w in range(n_windows - 1, -1, -1):
        for _ in range(window_bits if w != n_windows - 1 else 0):
            acc = jac_double(acc)
        buckets = [J_INF] * (1 << window_bits)
        shift = w * window_bits
        mask = (1 << window_bits) - 1
        for p, s in zip(pts, sc):
            d = (s >> shift) & mask
            if d:
                buckets[d] = jac_add(buckets[d], p)
        # running-sum trick: sum_d d * bucket_d
        running = J_INF
        total = J_INF
        for d in range((1 << window_bits) - 1, 0, -1):
            running = jac_add(running, buckets[d])
            total = jac_add(total, running)
        acc = jac_add(acc, total)
    return jac_to_affine(acc)
