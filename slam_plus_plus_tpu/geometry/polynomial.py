"""Reusable polynomial module: closed-form low-order root solvers, a
general companion-matrix solver, and robust least-squares polynomial
fitting.

Reference analogue: include/geometry/PolySolve.h (CQuadraticEq:219,
CCubicEq:419, CQuarticEq:646 — closed-form solvers with the
depressed-form/resolvent decompositions) and include/geometry/Polynomial.h
(least-squares polynomial fitting over lazy observation adaptors with
optional robust score functions / IRLS, :543-1168).  The reference's
five-point solver carries its own inline elimination; this module is the
standalone, reusable component it also ships.

Accelerator-first shape: the closed-form solvers are batched jnp over a leading
axis (one vectorized dispatch for any number of equations — the role the
reference's templated scalar solvers fill one equation at a time); the
general solver uses the companion-matrix eigenvalues on host numpy (LAPACK,
research-scale); the fitter is a normal-equations solve with optional IRLS
reweighting, vmappable.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp


_EPS = 1e-30


def quadratic_roots(a, b, c):
    """Real roots of a x^2 + b x + c, batched over leading dims.

    Returns (roots [..., 2], count [...]): roots sorted ascending, invalid
    lanes hold NaN.  Degenerate a==0 falls back to the linear root
    (reference CQuadraticEq handles the same degeneracies, PolySolve.h:219).
    Uses the numerically stable q-formula (no cancellation)."""
    a, b, c = jnp.broadcast_arrays(*map(jnp.asarray, (a, b, c)))
    lin = jnp.abs(a) < _EPS
    disc = b * b - 4.0 * a * c
    has2 = (disc >= 0) & ~lin
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b + (b == 0)) * sq)
    r1 = q / jnp.where(jnp.abs(a) < _EPS, 1.0, a)
    r2 = c / jnp.where(jnp.abs(q) < _EPS, 1.0, q)
    lo = jnp.minimum(r1, r2)
    hi = jnp.maximum(r1, r2)
    lroot = -c / jnp.where(lin, jnp.where(jnp.abs(b) < _EPS, 1.0, b), 1.0)
    nan = jnp.full_like(lo, jnp.nan)
    roots = jnp.stack(
        [jnp.where(lin, jnp.where(jnp.abs(b) < _EPS, nan, lroot),
                   jnp.where(has2, lo, nan)),
         jnp.where(lin, nan, jnp.where(has2, hi, nan))], axis=-1)
    count = jnp.where(lin, (jnp.abs(b) >= _EPS).astype(jnp.int32),
                      2 * has2.astype(jnp.int32))
    return roots, count


def cubic_roots(a, b, c, d):
    """Real roots of a x^3 + ... + d (a != 0), batched; trigonometric /
    Cardano closed form on the depressed cubic (reference CCubicEq,
    PolySolve.h:419).  Returns (roots [..., 3], count [...]) with NaN
    padding; roots unsorted (first lane always valid)."""
    a, b, c, d = jnp.broadcast_arrays(*map(jnp.asarray, (a, b, c, d)))
    inv_a = 1.0 / a
    B, C, D = b * inv_a, c * inv_a, d * inv_a
    off = B / 3.0
    p = C - B * B / 3.0
    q = 2.0 * B ** 3 / 27.0 - B * C / 3.0 + D
    disc = (q * q) / 4.0 + (p ** 3) / 27.0

    # one real root (disc > 0): Cardano
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    r_single = u + v - off

    # three real roots (disc <= 0): trigonometric
    pm = jnp.minimum(p, -_EPS)
    m = 2.0 * jnp.sqrt(-pm / 3.0)
    arg = jnp.clip(3.0 * q / (pm * m), -1.0, 1.0)
    th = jnp.arccos(arg) / 3.0
    k = jnp.arange(3.0)
    tri = (m[..., None] * jnp.cos(th[..., None] - 2.0 * jnp.pi * k / 3.0)
           - off[..., None])

    three = disc <= 0
    nan = jnp.nan * r_single
    roots = jnp.stack(
        [jnp.where(three, tri[..., 0], r_single),
         jnp.where(three, tri[..., 1], nan),
         jnp.where(three, tri[..., 2], nan)], axis=-1)
    count = jnp.where(three, 3, 1).astype(jnp.int32)
    return roots, count


def quartic_roots(a, b, c, d, e):
    """Real roots of the quartic via the resolvent-cubic / two-quadratics
    decomposition of the depressed form (reference CQuarticEq,
    PolySolve.h:646-780).  Batched; returns (roots [..., 4], count)."""
    a, b, c, d, e = jnp.broadcast_arrays(*map(jnp.asarray, (a, b, c, d, e)))
    inv_a = 1.0 / a
    B, C, D, E = b * inv_a, c * inv_a, d * inv_a, e * inv_a
    off = B / 4.0
    # depressed: u^4 + alpha u^2 + beta u + gamma
    alpha = C - 3.0 * B * B / 8.0
    beta = D - B * C / 2.0 + B ** 3 / 8.0
    gamma = E - 3.0 * B ** 4 / 256.0 + B * B * C / 16.0 - B * D / 4.0

    # resolvent cubic: y^3 + (5a/2) y^2 + (2a^2-g) y + (a^3/2 - ag/2 - b^2/8)
    ry, _cnt = cubic_roots(jnp.ones_like(alpha), 2.5 * alpha,
                           2.0 * alpha * alpha - gamma,
                           0.5 * alpha ** 3 - 0.5 * alpha * gamma
                           - beta * beta / 8.0)
    y = ry[..., 0]
    w2 = alpha + 2.0 * y
    w = jnp.sqrt(jnp.maximum(w2, 0.0))
    ok_w = w2 > _EPS
    t = jnp.where(ok_w, beta / (2.0 * jnp.where(ok_w, w, 1.0)), 0.0)
    # u^2 +- w u + (alpha + y -+ t) = 0
    r12, _ = quadratic_roots(jnp.ones_like(w), w, alpha + y - t)
    r34, _ = quadratic_roots(jnp.ones_like(w), -w, alpha + y + t)
    roots = jnp.concatenate([r12, r34], axis=-1) - off[..., None]
    count = jnp.sum(jnp.isfinite(roots), axis=-1).astype(jnp.int32)
    return roots, count


def polish_roots(coeffs, roots, iters: int = 2):
    """Newton-polish roots of polynomial sum_k coeffs[..., k] x^(n-k)
    (highest power first) — the reference polishes its closed-form roots
    the same way (PolySolve.h f_ImproveRoot)."""
    coeffs = jnp.asarray(coeffs)
    x = jnp.asarray(roots)
    n = coeffs.shape[-1] - 1
    for _ in range(iters):
        f = jnp.zeros_like(x)
        df = jnp.zeros_like(x)
        for k in range(n + 1):
            ck = coeffs[..., k][..., None]
            f = f * x + ck
            if k < n:
                df = df * x + ck * (n - k)
        x = x - jnp.where(jnp.abs(df) > _EPS, f / df, 0.0)
    return x


def roots_companion(coeffs: np.ndarray) -> np.ndarray:
    """All (complex) roots of one polynomial via companion-matrix
    eigenvalues on host (LAPACK) — the general fallback for degree > 4."""
    c = np.asarray(coeffs, dtype=np.float64)
    c = np.trim_zeros(c, "f")
    if len(c) <= 1:
        return np.zeros(0, dtype=np.complex128)
    return np.roots(c)


def polyfit_robust(x, y, degree: int, loss: str | None = None,
                   scale: float = 1.0, irls_iters: int = 5):
    """Least-squares polynomial fit with optional robust IRLS reweighting.

    The reference's Polynomial.h fitter role: normal equations over the
    Vandermonde basis (its CPolynomial::LeastSquares_Fit, Polynomial.h:543)
    with score-function reweighting (:791-951).  loss names index
    robust.losses.LOSSES.  Returns coeffs highest-power-first [degree+1]."""
    x = jnp.asarray(x, dtype=jnp.result_type(float))
    y = jnp.asarray(y, dtype=x.dtype)
    V = jnp.stack([x ** k for k in range(degree, -1, -1)], axis=-1)

    def wls(w):
        Vw = V * w[:, None]
        A = Vw.T @ V
        rhs = Vw.T @ y
        return jnp.linalg.solve(A + 1e-12 * jnp.eye(degree + 1,
                                                    dtype=x.dtype), rhs)

    w = jnp.ones_like(y)
    coef = wls(w)
    if loss is not None:
        from slam_plus_plus_tpu.robust.losses import LOSSES
        lf = LOSSES[loss]
        for _ in range(irls_iters):
            r = V @ coef - y
            w = lf(jnp.abs(r) / scale)
            coef = wls(w)
    return coef
