"""Rational functions p/q -- the fitted objects of KLARAPTOR (paper Section V-E).

A rational function is "simply a fraction of two polynomials" with per-variable
degree bounds on numerator and denominator.  The denominator is normalized so
that its first (graded-lex lowest) nonzero coefficient is 1, resolving the
scale ambiguity of the projective coefficient vector returned by the SVD fit.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .polynomial import Polynomial, monomial_exponents

__all__ = ["RationalFunction", "clamp_from_zero"]


def clamp_from_zero(x: np.ndarray, eps: float = 1e-300) -> np.ndarray:
    """Sign-preserving clamp away from zero: |x| < eps -> copysign(eps, x).

    Shared guard for near-zero denominators (rational-function evaluation
    and the expression IR's division node): a tiny negative denominator must
    stay negative -- flipping it would negate the whole quotient.
    """
    return np.where(np.abs(x) < eps, np.copysign(eps, x), x)


@dataclass
class RationalFunction:
    numerator: Polynomial
    denominator: Polynomial

    # -- evaluation ---------------------------------------------------------
    def __call__(self, X: np.ndarray) -> np.ndarray:
        num = self.numerator(X)
        den = self.denominator(X)
        # Guard against near-zero denominators: the fitter rejects candidates
        # whose denominator changes sign on the sample domain, but evaluation
        # outside that domain (extrapolation) can still come close to a pole.
        den = clamp_from_zero(den)
        return num / den

    def eval_dict(self, values: dict[str, float]) -> float:
        x = np.array(
            [[values[v] for v in self.numerator.var_names]], dtype=np.float64
        )
        return float(self(x)[0])

    @property
    def var_names(self) -> tuple[str, ...]:
        return self.numerator.var_names

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_coeffs(
        cls,
        var_names: Sequence[str],
        num_exps: Sequence[tuple[int, ...]],
        num_coeffs: np.ndarray,
        den_exps: Sequence[tuple[int, ...]],
        den_coeffs: np.ndarray,
    ) -> "RationalFunction":
        num_coeffs = np.asarray(num_coeffs, dtype=np.float64)
        den_coeffs = np.asarray(den_coeffs, dtype=np.float64)
        # Normalize: first nonzero denominator coefficient = 1.
        nz = np.nonzero(np.abs(den_coeffs) > 0)[0]
        if nz.size:
            scale = den_coeffs[nz[0]]
            num_coeffs = num_coeffs / scale
            den_coeffs = den_coeffs / scale
        return cls(
            Polynomial(tuple(var_names), tuple(num_exps), num_coeffs),
            Polynomial(tuple(var_names), tuple(den_exps), den_coeffs),
        )

    @classmethod
    def polynomial(cls, poly: Polynomial) -> "RationalFunction":
        return cls(poly, Polynomial.constant(poly.var_names, 1.0))

    @classmethod
    def constant(cls, var_names: Sequence[str], value: float) -> "RationalFunction":
        return cls.polynomial(Polynomial.constant(var_names, value))

    # -- safety checks --------------------------------------------------------
    def denominator_sign_stable(self, X: np.ndarray, margin: float = 1e-12) -> bool:
        """True if q does not vanish / change sign over the sample points X.

        The fitter uses this to reject spurious fits with poles inside the
        domain of interest (paper Section V-E: extrapolation stability).
        """
        den = self.denominator(X)
        return bool(np.all(den > margin) or np.all(den < -margin))

    # -- serialization ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "vars": list(self.var_names),
                "num": {
                    "exps": [list(e) for e in self.numerator.exponents],
                    "coeffs": self.numerator.coeffs.tolist(),
                },
                "den": {
                    "exps": [list(e) for e in self.denominator.exponents],
                    "coeffs": self.denominator.coeffs.tolist(),
                },
            }
        )

    @classmethod
    def from_json(cls, s: str) -> "RationalFunction":
        d = json.loads(s)
        return cls(
            Polynomial(
                tuple(d["vars"]),
                tuple(tuple(e) for e in d["num"]["exps"]),
                np.array(d["num"]["coeffs"]),
            ),
            Polynomial(
                tuple(d["vars"]),
                tuple(tuple(e) for e in d["den"]["exps"]),
                np.array(d["den"]["coeffs"]),
            ),
        )

    # -- codegen ---------------------------------------------------------------
    def to_source(self) -> str:
        num = self.numerator.to_source()
        den = self.denominator.to_source()
        if den == "1.0":
            return f"({num})"
        return f"(({num}) / ({den}))"

    def __repr__(self) -> str:  # pragma: no cover
        return f"RationalFunction({self.to_source()})"


def full_bases(
    var_names: Sequence[str],
    num_bounds: Sequence[int],
    den_bounds: Sequence[int],
    total_degree: int | None = None,
):
    """Monomial bases for a (num_bounds, den_bounds) rational model."""
    return (
        monomial_exponents(num_bounds, total_degree),
        monomial_exponents(den_bounds, total_degree),
    )
