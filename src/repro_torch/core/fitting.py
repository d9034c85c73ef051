"""Rational-function estimation by SVD least squares (paper Section V-E).

Given noisy samples (x_k, y_k) of a low-level metric, determine a rational
function g(x) = p(x)/q(x) with per-variable degree bounds.  Linearizing
``p(x_k) - y_k q(x_k) = 0`` over the monomial coefficients yields the system

    [ V_p  | -diag(y) V_q ] [alpha; beta] = 0

where V_p, V_q are Vandermonde-like design matrices.  As the paper notes, the
system is built from monomial evaluations, hence severely ill-conditioned and
multicollinear (rank-deficient), so QR is unusable; the minimizer under
||(alpha, beta)|| = 1 is the right singular vector of the smallest singular
value -- the SVD method.  We additionally:

 * scale each variable to [0, 1] before building monomials (conditioning),
   folding the scale back into the returned coefficients;
 * weight rows by 1/|y| so the fit minimizes *relative* error (execution
   times span orders of magnitude across the (D, P) domain);
 * reject candidate fits whose denominator changes sign on the sample domain
   (poles make extrapolation meaningless);
 * perform degree-bound model selection by k-fold cross-validation with a
   parsimony penalty, mirroring "these degree bounds ... are relatively
   small" -- the search space is tiny;
 * skip degree bounds whose monomials the distinct sample points do not
   determine (a rank-deficient design): there a numerator that vanishes on
   every sample point over a zero denominator solves the system exactly,
   and the SVD returns that 0/0 instead of a fit.  A kernel compiled for a
   few tile sizes (the bf16 wgmma matmul's nine tiles, which miss three
   corners of their 2 x 3 x 2 grid) is sampled at only those points.  The
   check applies to the fit on all the samples, the one ``fit_auto``
   returns: a cross-validation fold that drops points may be
   rank-deficient where the whole set is not, and its fit is scored as the
   JAX package scores it (a 0/0 fold fit fails its held-out points);
 * give the polynomial fallback no more monomials than there are distinct
   sample points, so it cannot interpolate them and report that as its
   error.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .polynomial import design_matrix, monomial_exponents
from .rational import RationalFunction

__all__ = ["FitResult", "fit_rational", "fit_polynomial", "fit_auto"]


@dataclass
class FitResult:
    function: RationalFunction
    rel_error: float                  # median relative error on training data
    cv_error: float                   # cross-validated median relative error
    num_bounds: tuple[int, ...]
    den_bounds: tuple[int, ...]
    n_params: int
    condition_number: float


def _scale_vars(X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    X = np.asarray(X, dtype=np.float64)
    scale = np.maximum(np.max(np.abs(X), axis=0), 1.0)
    return X / scale, scale


def _unscale_coeffs(
    coeffs: np.ndarray, exponents: Sequence[tuple[int, ...]], scale: np.ndarray
) -> np.ndarray:
    """Coefficients fitted on x/s correspond to c / prod(s^e) on raw x."""
    out = np.array(coeffs, dtype=np.float64)
    for i, e in enumerate(exponents):
        denom = 1.0
        for k, p in enumerate(e):
            if p:
                denom *= scale[k] ** p
        out[i] = out[i] / denom
    return out


def _solve_svd(
    Xs: np.ndarray,
    y: np.ndarray,
    num_exps: Sequence[tuple[int, ...]],
    den_exps: Sequence[tuple[int, ...]],
    weights: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, float]:
    Vp = design_matrix(Xs, num_exps)
    Vq = design_matrix(Xs, den_exps)
    M = np.concatenate([Vp, -(y[:, None]) * Vq], axis=1)
    M = weights[:, None] * M
    # SVD: minimizer of ||M c|| with ||c||=1 is the last right singular vector.
    try:
        _, s, Vt = np.linalg.svd(M, full_matrices=False)
    except np.linalg.LinAlgError:  # pragma: no cover - extremely rare
        return np.zeros(len(num_exps)), np.ones(len(den_exps)), np.inf
    c = Vt[-1]
    cond = float(s[0] / max(s[-1], 1e-300))
    return c[: len(num_exps)], c[len(num_exps):], cond


def fit_rational(
    X: np.ndarray,
    y: np.ndarray,
    var_names: Sequence[str],
    num_bounds: Sequence[int],
    den_bounds: Sequence[int],
    total_degree: int | None = None,
) -> FitResult | None:
    """Single fit with fixed degree bounds.  None if denominator is unstable."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    y = np.asarray(y, dtype=np.float64)
    Xs, scale = _scale_vars(X)
    num_exps = monomial_exponents(num_bounds, total_degree)
    den_exps = monomial_exponents(den_bounds, total_degree)
    if len(num_exps) + len(den_exps) > X.shape[0] + 1:
        return None  # underdetermined even before noise; skip
    weights = 1.0 / np.maximum(np.abs(y), 1e-12)
    alpha_s, beta_s, cond = _solve_svd(Xs, y, num_exps, den_exps, weights)
    alpha = _unscale_coeffs(alpha_s, num_exps, scale)
    beta = _unscale_coeffs(beta_s, den_exps, scale)
    rf = RationalFunction.from_coeffs(var_names, num_exps, alpha, den_exps, beta)
    if not rf.denominator_sign_stable(X):
        return None
    pred = rf(X)
    rel = np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)
    return FitResult(
        function=rf,
        rel_error=float(np.median(rel)),
        cv_error=float("nan"),
        num_bounds=tuple(num_bounds),
        den_bounds=tuple(den_bounds),
        n_params=len(num_exps) + len(den_exps),
        condition_number=cond,
    )


def fit_polynomial(
    X: np.ndarray,
    y: np.ndarray,
    var_names: Sequence[str],
    bounds: Sequence[int],
    total_degree: int | None = None,
) -> FitResult:
    """Plain weighted polynomial least squares (q = 1) -- the safe fallback."""
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    y = np.asarray(y, dtype=np.float64)
    Xs, scale = _scale_vars(X)
    exps = monomial_exponents(bounds, total_degree)
    V = design_matrix(Xs, exps)
    w = 1.0 / np.maximum(np.abs(y), 1e-12)
    # lstsq on the weighted system; SVD-based under the hood (numpy gelsd).
    coeffs_s, *_ = np.linalg.lstsq(w[:, None] * V, w * y, rcond=None)
    coeffs = _unscale_coeffs(coeffs_s, exps, scale)
    from .polynomial import Polynomial

    rf = RationalFunction.polynomial(Polynomial(tuple(var_names), tuple(exps), coeffs))
    pred = rf(X)
    rel = np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)
    return FitResult(
        function=rf,
        rel_error=float(np.median(rel)),
        cv_error=float("nan"),
        num_bounds=tuple(bounds),
        den_bounds=tuple(0 for _ in bounds),
        n_params=len(exps),
        condition_number=float("nan"),
    )


def _cv_error(
    X: np.ndarray,
    y: np.ndarray,
    var_names: Sequence[str],
    num_bounds: Sequence[int],
    den_bounds: Sequence[int],
    total_degree: int | None,
    k: int = 4,
    seed: int = 0,
) -> float:
    """K-fold cross-validated median relative error for one degree-bound pair."""
    n = X.shape[0]
    if n < 2 * k:
        k = max(2, n // 4) if n >= 8 else 2
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    errs: list[float] = []
    for f in folds:
        mask = np.ones(n, dtype=bool)
        mask[f] = False
        if not np.any(mask):
            continue
        res = fit_rational(X[mask], y[mask], var_names, num_bounds, den_bounds,
                           total_degree)
        if res is None:
            return float("inf")
        pred = res.function(X[f])
        rel = np.abs(pred - y[f]) / np.maximum(np.abs(y[f]), 1e-12)
        errs.extend(rel.tolist())
    return float(np.median(errs)) if errs else float("inf")


def _identified(points: np.ndarray, bounds: Sequence[int],
                total_degree: int | None) -> bool:
    """Whether the distinct (scaled) sample ``points`` determine every
    monomial within ``bounds``: a full-rank design on them."""
    exps = monomial_exponents(bounds, total_degree)
    return np.linalg.matrix_rank(design_matrix(points, exps)) == len(exps)


def fit_auto(
    X: np.ndarray,
    y: np.ndarray,
    var_names: Sequence[str],
    max_num_degree: int = 3,
    max_den_degree: int = 2,
    total_degree: int | None = 4,
    parsimony: float = 0.005,
) -> FitResult:
    """Degree-bound model selection (the paper's 'relatively small' bounds).

    Tries uniform per-variable bounds (u, v) for u in 1..max_num_degree and
    v in 0..max_den_degree, scores each by k-fold CV plus a parsimony penalty
    per parameter, refits the winner on all data, and falls back to a plain
    polynomial fit if every rational candidate has an unstable denominator
    or monomials the samples do not determine.
    """
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    y = np.asarray(y, dtype=np.float64)
    nv = X.shape[1]
    points = np.unique(_scale_vars(X)[0], axis=0)
    best: FitResult | None = None
    best_score = float("inf")
    for u, v in itertools.product(
        range(1, max_num_degree + 1), range(0, max_den_degree + 1)
    ):
        nb, db = (u,) * nv, (v,) * nv
        if not (_identified(points, nb, total_degree)
                and _identified(points, db, total_degree)):
            continue
        cv = _cv_error(X, y, var_names, nb, db, total_degree)
        if not np.isfinite(cv):
            continue
        res = fit_rational(X, y, var_names, nb, db, total_degree)
        if res is None:
            continue
        score = cv + parsimony * res.n_params
        if score < best_score:
            res.cv_error = cv
            best, best_score = res, score
    if best is None:
        u = max_num_degree
        while u > 0 and len(monomial_exponents((u,) * nv, total_degree)) \
                > len(points):
            u -= 1
        best = fit_polynomial(X, y, var_names, (u,) * nv, total_degree)
        best.cv_error = best.rel_error
    return best
