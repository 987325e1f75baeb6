"""Radix-2 evaluation domains over Fr (host-side bookkeeping + reference
NTT used as the oracle for the device kernels).

Mirrors the role of dusk-plonk's `fft::EvaluationDomain` (SURVEY.md
§2.6): size = next power of two >= circuit size, generator = the 2^32
root of unity raised appropriately; coset domains use the field
multiplicative generator (7) as the coset shift.
"""

from ..params import R_MOD, ROOT_OF_UNITY, TWO_ADICITY, FR_GENERATOR
from ..fields import fr


class Domain:
    def __init__(self, size: int):
        assert size > 0 and size & (size - 1) == 0, "size must be a power of two"
        k = size.bit_length() - 1
        assert k <= TWO_ADICITY
        self.n = size
        self.log_n = k
        self.omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - k), R_MOD)
        self.omega_inv = pow(self.omega, -1, R_MOD)
        self.n_inv = pow(size, -1, R_MOD)
        self.coset_gen = FR_GENERATOR

    @staticmethod
    def for_circuit(n_gates: int) -> "Domain":
        size = 1
        while size < n_gates:
            size <<= 1
        return Domain(size)

    def elements(self):
        """All n domain elements 1, w, w^2, ... (host ints)."""
        out = [1] * self.n
        for i in range(1, self.n):
            out[i] = out[i - 1] * self.omega % R_MOD
        return out

    def vanishing_eval(self, x: int) -> int:
        """Z_H(x) = x^n - 1."""
        return (pow(x, self.n, R_MOD) - 1) % R_MOD

    def lagrange_evals(self, x: int, count: int = None):
        """L_i(x) = (w^i / n) * (x^n - 1)/(x - w^i) for i < count."""
        count = self.n if count is None else count
        zh = self.vanishing_eval(x)
        if zh == 0:
            # x is in the domain: L_i(x) = delta
            elems = self.elements()
            return [1 if x == elems[i] else 0 for i in range(count)]
        denoms = []
        wi = 1
        for i in range(count):
            denoms.append((x - wi) % R_MOD)
            wi = wi * self.omega % R_MOD
        inv_d = fr.batch_inv(denoms)
        out = []
        wi = 1
        for i in range(count):
            out.append(zh * self.n_inv % R_MOD * wi % R_MOD * inv_d[i] % R_MOD)
            wi = wi * self.omega % R_MOD
        return out

    # --- host reference NTT (oracle for device kernels, small sizes) ---

    def ntt(self, coeffs):
        """Evaluations over H from coefficients (natural order)."""
        return _ntt_host(list(coeffs) + [0] * (self.n - len(coeffs)), self.omega)

    def intt(self, evals):
        coeffs = _ntt_host(list(evals), self.omega_inv)
        return [c * self.n_inv % R_MOD for c in coeffs]

    def coset_ntt(self, coeffs, shift: int = None):
        g = self.coset_gen if shift is None else shift
        scaled, gi = [], 1
        padded = list(coeffs) + [0] * (self.n - len(coeffs))
        for c in padded:
            scaled.append(c * gi % R_MOD)
            gi = gi * g % R_MOD
        return _ntt_host(scaled, self.omega)

    def coset_intt(self, evals, shift: int = None):
        g = self.coset_gen if shift is None else shift
        g_inv = pow(g, -1, R_MOD)
        coeffs = self.intt(evals)
        out, gi = [], 1
        for c in coeffs:
            out.append(c * gi % R_MOD)
            gi = gi * g_inv % R_MOD
        return out


def _ntt_host(values, omega):
    """Iterative DIT NTT on python ints (bit-reversal + butterflies)."""
    n = len(values)
    x = list(values)
    # bit reversal
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            x[i], x[j] = x[j], x[i]
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), R_MOD)
        for start in range(0, n, 2 * m):
            w = 1
            for k in range(m):
                lo = x[start + k]
                hi = x[start + k + m] * w % R_MOD
                x[start + k] = (lo + hi) % R_MOD
                x[start + k + m] = (lo - hi) % R_MOD
                w = w * w_m % R_MOD
        m *= 2
    return x
