"""Nistér/Stewénius 5-point minimal essential solver (host NumPy).

Behavioral reference: essential.cpp:9-218 (nullspace basis -> Gröbner
polynomial system -> 10x10 action-matrix eigendecomposition). A copy of the
JAX package's ops/essential5.py (NumPy only; that package's __init__ loads
JAX, so nothing is imported from it). This is an independent from-scratch implementation of
the same published algorithm (Stewénius et al., "Recent developments on
direct relative orientation"): instead of a transcribed coefficient table,
the ten cubic constraints are expanded at runtime with a tiny trivariate
polynomial arithmetic over the 20-monomial basis — slower to build (a few
hundred microseconds) but table-free and self-evidently correct.

Placement: HOST. The solver runs only inside initialization (once per
bootstrap attempt), so a host solve costs nothing at frame rate. The batched
8-point eigh solver (ops/epipolar.py) remains the per-frame device path;
config.initializer_use_5pt decides which the initializer uses.
"""

from __future__ import annotations

import numpy as np

# monomial exponent table for (x, y, z) up to total degree 3, ordered as
# [cubics (10) | quadratics (6) | linears (3) | constant (1)]
_MONOMIALS = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
    (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1),
    (0, 0, 0),
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
N_MONO = len(_MONOMIALS)


def _poly(const=0.0):
    p = np.zeros(N_MONO)
    p[_MONO_INDEX[(0, 0, 0)]] = const
    return p


def _poly_var(i):
    p = np.zeros(N_MONO)
    p[_MONO_INDEX[tuple(int(k == i) for k in range(3))]] = 1.0
    return p


def _pmul(a, b):
    """Product of two polynomials in the 20-monomial basis (degrees must not
    exceed 3 in the result)."""
    out = np.zeros(N_MONO)
    nz_a = np.flatnonzero(a)
    nz_b = np.flatnonzero(b)
    for i in nz_a:
        mi = _MONOMIALS[i]
        for j in nz_b:
            mj = _MONOMIALS[j]
            m = (mi[0] + mj[0], mi[1] + mj[1], mi[2] + mj[2])
            out[_MONO_INDEX[m]] += a[i] * b[j]
    return out


def solve_essential_5pt(p1, p2):
    """Essential matrices from 5 normalized-image-point correspondences.

    Args:
      p1, p2: (5, 2) normalized points with p2^T E p1 = 0.
    Returns:
      E: (M, 3, 3) real candidate essential matrices (M <= 10).
    """
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    # epipolar design matrix rows: kron(h(p2), h(p1)) for e = vec(E) row-major
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    one = np.ones_like(x1)
    A = np.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], axis=-1
    )  # (5, 9)
    # 4-dim nullspace basis
    _, _, Vt = np.linalg.svd(A)
    basis = Vt[5:9]  # (4, 9): E = x*B0 + y*B1 + z*B2 + B3

    x, y, z = _poly_var(0), _poly_var(1), _poly_var(2)
    coeffs = [x, y, z, _poly(1.0)]
    # E entries as degree-1 polynomials
    Epoly = [[np.zeros(N_MONO) for _ in range(3)] for _ in range(3)]
    for b in range(4):
        B = basis[b].reshape(3, 3)
        for r in range(3):
            for c in range(3):
                Epoly[r][c] = Epoly[r][c] + coeffs[b] * B[r, c]

    def pdot(row_a, row_b):
        s = np.zeros(N_MONO)
        for k in range(3):
            s += _pmul(row_a[k], row_b[k])
        return s

    # constraint 1: det(E) = 0
    def det3(E):
        return (
            _pmul(E[0][0], _pmul(E[1][1], E[2][2]))
            - _pmul(E[0][0], _pmul(E[1][2], E[2][1]))
            - _pmul(E[0][1], _pmul(E[1][0], E[2][2]))
            + _pmul(E[0][1], _pmul(E[1][2], E[2][0]))
            + _pmul(E[0][2], _pmul(E[1][0], E[2][1]))
            - _pmul(E[0][2], _pmul(E[1][1], E[2][0]))
        )

    constraints = [det3(Epoly)]

    # constraint 2: 2 E E^T E - tr(E E^T) E = 0 (9 cubics)
    # G = E E^T (symmetric, degree 2)
    G = [[pdot(Epoly[r], Epoly[c]) for c in range(3)] for r in range(3)]
    trG = G[0][0] + G[1][1] + G[2][2]
    for r in range(3):
        for c in range(3):
            s = np.zeros(N_MONO)
            for k in range(3):
                s += _pmul(G[r][k], Epoly[k][c])
            constraints.append(2.0 * s - _pmul(trG, Epoly[r][c]))

    C = np.stack(constraints)  # (10, 20)
    Ac = C[:, :10]
    Bc = C[:, 10:]
    try:
        M = np.linalg.solve(Ac, Bc)  # cubic monomials = -M @ lower monomials
    except np.linalg.LinAlgError:
        return np.zeros((0, 3, 3))

    # action matrix for multiplication by x on the quotient-ring basis
    # [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1]
    act = np.zeros((10, 10))
    # x * basis[i] -> cubic monomial index in _MONOMIALS[:10] for i < 6
    cubic_of = [0, 1, 2, 3, 4, 5]  # x*x^2=x^3(0), x*xy=x^2y(1), x*xz=x^2z(2),
    # x*y^2=xy^2(3), x*yz=xyz(4), x*z^2=xz^2(5)
    for i in range(6):
        act[:, i] = -M[cubic_of[i], :]
    act[0, 6] = 1.0   # x * x = x^2
    act[1, 7] = 1.0   # x * y = xy
    act[2, 8] = 1.0   # x * z = xz
    act[6, 9] = 1.0   # x * 1 = x
    # monomial-evaluation vectors are LEFT eigenvectors of the multiplication
    # operator (v^T M_x = x(s) v^T), i.e. right eigenvectors of its transpose
    w, V = np.linalg.eig(act.T)

    Es = []
    for i in range(10):
        if abs(w[i].imag) > 1e-6 * (1.0 + abs(w[i].real)):
            continue
        v = V[:, i].real
        if abs(v[9]) < 1e-12:
            continue
        xs, ys, zs = v[6] / v[9], v[7] / v[9], v[8] / v[9]
        e = xs * basis[0] + ys * basis[1] + zs * basis[2] + basis[3]
        E = e.reshape(3, 3)
        n = np.linalg.norm(E)
        if n > 1e-12 and np.isfinite(E).all():
            Es.append(E / n)
    if not Es:
        return np.zeros((0, 3, 3))
    return np.stack(Es)


def ransac_essential_5pt(rng, p1, p2, valid, threshold, num_samples: int = 64):
    """Host 5-point RANSAC: minimal 5-point solves, symmetric epipolar score
    (same bound as the 8-point path: 2 * 3.84 * threshold^2). Used by the
    initializer (runs once per bootstrap attempt)."""
    from rd_vio_tpu_torch.ops.frontend_step_np import essential_geometric_error_np

    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    valid = np.asarray(valid, bool)
    ids = np.flatnonzero(valid)
    if len(ids) < 5:
        return None, np.zeros_like(valid)
    bound = 2.0 * 3.84 * threshold**2
    best_E, best_cnt, best_mask = None, -1, np.zeros_like(valid)
    for _ in range(num_samples):
        sel = rng.choice(ids, size=5, replace=False)
        for E in solve_essential_5pt(p1[sel], p2[sel]):
            err = essential_geometric_error_np(E, p1, p2) + \
                essential_geometric_error_np(E.T, p2, p1)
            mask = (err <= bound) & valid
            cnt = int(mask.sum())
            if cnt > best_cnt:
                best_E, best_cnt, best_mask = E, cnt, mask
    return best_E, best_mask
