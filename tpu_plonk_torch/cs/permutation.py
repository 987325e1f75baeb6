"""Copy-constraint (permutation) bookkeeping: variables -> sigma
polynomials over the 4 wire cosets (SURVEY.md §2.7 "permutation
bookkeeping"; dusk constants K1=7, K2=13, K3=17).

Position (col j, row i) has identity value k_j * w^i with
k = (1, K1, K2, K3).  sigma maps each position to the next position of
the same variable's cycle; evaluating sigma over the domain gives the
four sigma polynomials (via iNTT in preprocessing).
"""

from ..params import R_MOD, K1, K2, K3
from ..poly.domain import Domain

KS = (1, K1, K2, K3)


def build_sigma_evals(composer, n: int):
    """Returns (sigma_evals, id_evals): two lists of 4 lists of n field
    elements — the evaluation form of sigma_j / id_j over the domain.
    Gates beyond composer.n_gates are padding (wires = var 0)."""
    dom = Domain(n)
    omegas = dom.elements()

    # cycle structure: variable -> list of (col, row)
    positions = {}
    for col in range(4):
        wire = composer.wires["abcd"[col]]
        for row in range(n):
            var = wire[row] if row < len(wire) else 0
            positions.setdefault(var, []).append((col, row))

    id_evals = [[KS[col] * omegas[row] % R_MOD for row in range(n)]
                for col in range(4)]
    sigma_evals = [list(col_vals) for col_vals in id_evals]
    for cycle in positions.values():
        m = len(cycle)
        for t in range(m):
            col, row = cycle[t]
            ncol, nrow = cycle[(t + 1) % m]
            sigma_evals[col][row] = id_evals[ncol][nrow]
    return sigma_evals, id_evals
