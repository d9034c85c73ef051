"""Multivariate polynomials over named variables.

The paper (Section V-E) fits rational functions whose numerator/denominator are
multivariate polynomials with per-variable degree bounds.  This module provides
the monomial-basis machinery: exponent enumeration, vectorized evaluation
(the Vandermonde-like design matrix of Section V-E), and pretty printing.

Everything here is plain numpy -- the fitted objects are later *code-generated*
into driver programs (core/codegen.py) and, where a JAX-traceable evaluator is
needed, compiled with jnp in core/rational_program.py.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "monomial_exponents",
    "design_matrix",
    "Polynomial",
]


def monomial_exponents(
    degree_bounds: Sequence[int], total_degree: int | None = None
) -> list[tuple[int, ...]]:
    """Enumerate exponent tuples with per-variable bounds ``degree_bounds``.

    ``total_degree`` optionally caps the sum of exponents (keeps the basis --
    and hence the number of fitted coefficients i, j of Section V-E -- small).
    Order is deterministic: graded lexicographic.
    """
    ranges = [range(b + 1) for b in degree_bounds]
    exps = [
        e
        for e in itertools.product(*ranges)
        if total_degree is None or sum(e) <= total_degree
    ]
    exps.sort(key=lambda e: (sum(e), e))
    return exps


def design_matrix(X: np.ndarray, exponents: Sequence[tuple[int, ...]]) -> np.ndarray:
    """Vandermonde-like matrix: rows = samples of X, cols = monomials.

    ``X``: (n_samples, n_vars).  Returns (n_samples, n_monomials) float64.
    This is exactly the ill-conditioned system the paper solves with SVD.
    """
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    n, v = X.shape
    cols = np.empty((n, len(exponents)), dtype=np.float64)
    for c, e in enumerate(exponents):
        col = np.ones(n, dtype=np.float64)
        for k in range(v):
            if e[k]:
                col = col * X[:, k] ** e[k]
        cols[:, c] = col
    return cols


@dataclass
class Polynomial:
    """A multivariate polynomial sum_c coeffs[c] * prod_k X_k^exponents[c][k]."""

    var_names: tuple[str, ...]
    exponents: tuple[tuple[int, ...], ...]
    coeffs: np.ndarray  # (n_monomials,) float64

    def __post_init__(self) -> None:
        self.coeffs = np.asarray(self.coeffs, dtype=np.float64)
        assert len(self.exponents) == self.coeffs.shape[0], (
            f"{len(self.exponents)} exponents vs {self.coeffs.shape[0]} coeffs"
        )
        for e in self.exponents:
            assert len(e) == len(self.var_names)

    # -- evaluation ---------------------------------------------------------
    def __call__(self, X: np.ndarray) -> np.ndarray:
        """Evaluate at sample matrix X (n_samples, n_vars) -> (n_samples,)."""
        return design_matrix(np.atleast_2d(np.asarray(X, dtype=np.float64)),
                             self.exponents) @ self.coeffs

    def eval_dict(self, values: dict[str, float]) -> float:
        x = np.array([[values[v] for v in self.var_names]], dtype=np.float64)
        return float(self(x)[0])

    # -- algebra helpers ----------------------------------------------------
    @classmethod
    def constant(cls, var_names: Sequence[str], value: float) -> "Polynomial":
        z = tuple(0 for _ in var_names)
        return cls(tuple(var_names), (z,), np.array([value]))

    def degree(self) -> int:
        nz = [sum(e) for e, c in zip(self.exponents, self.coeffs) if abs(c) > 0]
        return max(nz) if nz else 0

    def prune(self, tol: float = 0.0) -> "Polynomial":
        """Drop coefficients with |c| <= tol (relative to max |c|)."""
        mx = float(np.max(np.abs(self.coeffs))) if self.coeffs.size else 0.0
        keep = [i for i, c in enumerate(self.coeffs) if abs(c) > tol * mx]
        if not keep:  # keep the constant term so the polynomial stays valid
            keep = [0]
        return Polynomial(
            self.var_names,
            tuple(self.exponents[i] for i in keep),
            self.coeffs[keep],
        )

    # -- printing / codegen --------------------------------------------------
    def to_source(self, fmt: str = "py") -> str:
        """Render as an executable Python expression over ``var_names``."""
        terms = []
        for e, c in zip(self.exponents, self.coeffs):
            if c == 0.0:
                continue
            parts = [repr(float(c))]
            for name, p in zip(self.var_names, e):
                if p == 1:
                    parts.append(name)
                elif p > 1:
                    parts.append(f"{name}**{p}")
            terms.append("*".join(parts))
        return " + ".join(terms) if terms else "0.0"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Polynomial({self.to_source()})"
