"""Rational programs (paper Section II, Definition 1 + extensions).

A *rational program* is a straight-line/branching program whose arithmetic is
restricted to +, -, *, integer comparison -- extended (as Definition 1 allows
without changing the class) with Euclidean division, floor/ceil, min/max and
rational-number arithmetic.  By Observation 1 such a program computes a
*piece-wise rational function* of its free variables; the decision nodes
partition the input space and each leaf is a rational function.

This module provides a small expression IR with exactly those operations:

  * numeric evaluation over numpy arrays (vectorized over sample points),
  * code generation to Python source (paper Section IV step 3 emits C; we
    emit Python -- see core/codegen.py for whole-driver emission),
  * flowchart export (the paper depicts rational programs as flowcharts,
    Fig. 2) for documentation and debugging,
  * piece counting: enumerate the rational-function pieces / partition cells,
  * fitted-RationalFunction leaves, so process nodes determined by curve
    fitting (Section III-A) plug directly into a known decision skeleton.

The IR deliberately has no loops: every performance-model instance we build
(occupancy, MBP-CBP execution time) is loop-free once hardware parameters are
fixed, matching the flowchart form of Fig. 2.  (Loops with rational bounds
would still denote PRFs -- Definition 1 permits them -- but we never need
them.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

import numpy as np

from .rational import RationalFunction, clamp_from_zero

__all__ = [
    "Expr", "Var", "Const", "BinOp", "Floor", "Ceil", "Min", "Max",
    "Select", "Fitted", "RationalProgram",
    "var", "const", "floor_div", "ceil_div", "specialize_expr",
]

Env = Mapping[str, np.ndarray]


class Expr:
    """Base expression node."""

    # -- operator sugar -----------------------------------------------------
    def __add__(self, o): return BinOp("+", self, _wrap(o))
    def __radd__(self, o): return BinOp("+", _wrap(o), self)
    def __sub__(self, o): return BinOp("-", self, _wrap(o))
    def __rsub__(self, o): return BinOp("-", _wrap(o), self)
    def __mul__(self, o): return BinOp("*", self, _wrap(o))
    def __rmul__(self, o): return BinOp("*", _wrap(o), self)
    def __truediv__(self, o): return BinOp("/", self, _wrap(o))
    def __rtruediv__(self, o): return BinOp("/", _wrap(o), self)
    def __lt__(self, o): return BinOp("<", self, _wrap(o))
    def __le__(self, o): return BinOp("<=", self, _wrap(o))
    def __gt__(self, o): return BinOp(">", self, _wrap(o))
    def __ge__(self, o): return BinOp(">=", self, _wrap(o))

    # -- interface -----------------------------------------------------------
    def eval(self, env: Env) -> np.ndarray:
        raise NotImplementedError

    def to_source(self, vector: bool = False) -> str:
        """Python source for this expression.

        ``vector=False`` emits scalar code (``math.floor``, ``min``, ternary
        conditionals) depending only on ``math``; ``vector=True`` emits
        ndarray-safe code (``np.floor``, ``np.minimum``, ``np.where``)
        depending only on ``numpy as np`` -- the form the generated drivers
        use to evaluate the rational program over a whole candidate table.
        """
        raise NotImplementedError

    def children(self) -> Iterable["Expr"]:
        return ()

    def free_vars(self) -> set[str]:
        out: set[str] = set()
        stack = [self]
        while stack:
            e = stack.pop()
            if isinstance(e, Var):
                out.add(e.name)
            stack.extend(e.children())
        return out

    def count_pieces(self) -> int:
        """Number of rational-function pieces (terminating leaves, as in the
        5-leaf Fig. 2 flowchart)."""
        if isinstance(self, Select):
            return self.if_true.count_pieces() + self.if_false.count_pieces()
        kids = list(self.children())
        if not kids:
            return 1
        prod = 1
        for k in kids:
            prod *= k.count_pieces()
        return prod

    def specialize(self, bindings: Mapping[str, float]) -> "Expr":
        """Partial evaluation: bind some free variables, fold constants.

        This is the launch-plan compilation primitive: specializing the
        rational program with respect to the data parameters D collapses
        every subexpression that depends only on D into a ``Const`` and
        folds decision nodes whose conditions became constant -- the
        remaining program is a (usually much smaller) rational function of
        the program parameters alone, and its piece count shrinks
        accordingly.  Unbound variables are left symbolic.
        """
        return specialize_expr(self, bindings)


def _wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    return Const(float(x))


@dataclass
class Var(Expr):
    name: str

    def eval(self, env: Env) -> np.ndarray:
        return np.asarray(env[self.name], dtype=np.float64)

    def to_source(self, vector: bool = False) -> str:
        return self.name


@dataclass
class Const(Expr):
    value: float

    def eval(self, env: Env) -> np.ndarray:
        return np.float64(self.value)

    def to_source(self, vector: bool = False) -> str:
        return repr(float(self.value))


_OPS: dict[str, Callable] = {
    "+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide,
    "<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal,
}


@dataclass
class BinOp(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def eval(self, env: Env) -> np.ndarray:
        l, r = self.lhs.eval(env), self.rhs.eval(env)
        if self.op == "/":
            r = clamp_from_zero(r)
        out = _OPS[self.op](l, r)
        return out.astype(np.float64) if out.dtype == bool else out

    def to_source(self, vector: bool = False) -> str:
        return (f"({self.lhs.to_source(vector)} {self.op} "
                f"{self.rhs.to_source(vector)})")

    def children(self):
        return (self.lhs, self.rhs)


@dataclass
class Floor(Expr):
    arg: Expr

    def eval(self, env: Env) -> np.ndarray:
        return np.floor(self.arg.eval(env))

    def to_source(self, vector: bool = False) -> str:
        if vector:
            return f"np.floor({self.arg.to_source(vector)})"
        return f"math.floor({self.arg.to_source()})"

    def children(self):
        return (self.arg,)


@dataclass
class Ceil(Expr):
    arg: Expr

    def eval(self, env: Env) -> np.ndarray:
        return np.ceil(self.arg.eval(env))

    def to_source(self, vector: bool = False) -> str:
        if vector:
            return f"np.ceil({self.arg.to_source(vector)})"
        return f"math.ceil({self.arg.to_source()})"

    def children(self):
        return (self.arg,)


@dataclass
class Min(Expr):
    lhs: Expr
    rhs: Expr

    def eval(self, env: Env) -> np.ndarray:
        return np.minimum(self.lhs.eval(env), self.rhs.eval(env))

    def to_source(self, vector: bool = False) -> str:
        if vector:
            return (f"np.minimum({self.lhs.to_source(vector)}, "
                    f"{self.rhs.to_source(vector)})")
        return f"min({self.lhs.to_source()}, {self.rhs.to_source()})"

    def children(self):
        return (self.lhs, self.rhs)


@dataclass
class Max(Expr):
    lhs: Expr
    rhs: Expr

    def eval(self, env: Env) -> np.ndarray:
        return np.maximum(self.lhs.eval(env), self.rhs.eval(env))

    def to_source(self, vector: bool = False) -> str:
        if vector:
            return (f"np.maximum({self.lhs.to_source(vector)}, "
                    f"{self.rhs.to_source(vector)})")
        return f"max({self.lhs.to_source()}, {self.rhs.to_source()})"

    def children(self):
        return (self.lhs, self.rhs)


@dataclass
class Select(Expr):
    """Decision node: if cond then if_true else if_false (Fig. 2 diamonds)."""

    cond: Expr
    if_true: Expr
    if_false: Expr

    def eval(self, env: Env) -> np.ndarray:
        c = self.cond.eval(env)
        return np.where(c.astype(bool), self.if_true.eval(env),
                        self.if_false.eval(env))

    def to_source(self, vector: bool = False) -> str:
        if vector:
            return (f"np.where({self.cond.to_source(vector)}, "
                    f"{self.if_true.to_source(vector)}, "
                    f"{self.if_false.to_source(vector)})")
        return (f"({self.if_true.to_source()} if {self.cond.to_source()} "
                f"else {self.if_false.to_source()})")

    def children(self):
        return (self.cond, self.if_true, self.if_false)


@dataclass
class Fitted(Expr):
    """Process node whose rational function was determined by curve fitting.

    Section III-A: the decision nodes of the flowchart are known, the process
    nodes are fitted RationalFunctions g_i(D, P).  ``bound`` carries partial
    application (``specialize`` pins some inputs to constants): a
    RationalFunction has no partially-applied form, so the pinned values are
    merged into the environment at evaluation time instead.
    """

    name: str
    fn: RationalFunction
    bound: dict = field(default_factory=dict)

    def eval(self, env: Env) -> np.ndarray:
        def col(v):
            x = self.bound[v] if v in self.bound else env[v]
            return np.asarray(x, dtype=np.float64)

        cols = np.broadcast_arrays(*[col(v) for v in self.fn.var_names])
        shape = cols[0].shape
        X = np.stack([c.ravel() for c in cols], axis=-1)
        return self.fn(X).reshape(shape) if shape else self.fn(X)[0]

    def to_source(self, vector: bool = False) -> str:
        if self.bound:
            # The emitted source would still reference the pinned names;
            # codegen only ever emits unspecialized Fitted nodes.
            raise NotImplementedError(
                "cannot emit source for a partially-applied Fitted node")
        return self.fn.to_source()

    def children(self):
        return ()


# -- partial evaluation (launch-plan compilation) ----------------------------

def specialize_expr(e: Expr, bindings: Mapping[str, float]) -> Expr:
    """Substitute ``bindings`` into ``e`` and constant-fold in one pass.

    Folding uses the same numeric semantics as ``eval`` (including the
    division-by-zero clamp), so a fully-bound expression specializes to the
    exact ``Const`` that evaluating it would produce.  ``Select`` nodes with
    a constant condition reduce to the taken branch -- decision diamonds of
    the Fig. 2 flowchart disappear once D is known.
    """
    if isinstance(e, Var):
        if e.name in bindings:
            return Const(float(bindings[e.name]))
        return e
    if isinstance(e, Const):
        return e
    if isinstance(e, Fitted):
        # A RationalFunction leaf folds to a constant when every input is
        # bound; a partial binding is carried as pinned values on the node
        # (there is no partially-applied RationalFunction form), so the
        # specialized program really only needs the still-free names.
        merged = dict(e.bound)
        merged.update({v: float(bindings[v]) for v in e.fn.var_names
                       if v in bindings})
        if all(v in merged for v in e.fn.var_names):
            return Const(float(Fitted(e.name, e.fn).eval(merged)))
        if merged == e.bound:
            return e
        return Fitted(e.name, e.fn, merged)
    if isinstance(e, Select):
        cond = specialize_expr(e.cond, bindings)
        if isinstance(cond, Const):
            taken = e.if_true if cond.value else e.if_false
            return specialize_expr(taken, bindings)
        return Select(cond, specialize_expr(e.if_true, bindings),
                      specialize_expr(e.if_false, bindings))
    if isinstance(e, (BinOp, Min, Max, Floor, Ceil)):
        kids = [specialize_expr(k, bindings) for k in e.children()]
        if isinstance(e, BinOp):
            out: Expr = BinOp(e.op, *kids)
        else:
            out = type(e)(*kids)
        if all(isinstance(k, Const) for k in kids):
            return Const(float(out.eval({})))
        return out
    raise TypeError(f"cannot specialize expression node {type(e).__name__}")


# -- helpers matching Definition 1's extensions ------------------------------

def var(name: str) -> Var:
    return Var(name)


def const(v: float) -> Const:
    return Const(v)


def floor_div(a: Expr, b: Expr) -> Expr:
    """Euclidean quotient -- expressible in a rational program (Section II-A)."""
    return Floor(_wrap(a) / _wrap(b))


def ceil_div(a: Expr, b: Expr) -> Expr:
    return Ceil(_wrap(a) / _wrap(b))


@dataclass
class RationalProgram:
    """A named rational program: free variables -> scalar output Y.

    ``outputs`` maps metric names to expression roots; the primary output is
    ``outputs[primary]``.  Evaluation is vectorized: pass arrays in the env to
    evaluate many (D, P) points at once (used by the runtime driver to scan
    the whole feasible configuration set in one shot -- Section IV step 4).
    """

    name: str
    inputs: tuple[str, ...]
    outputs: dict[str, Expr]
    primary: str = "E"

    def eval(self, env: Env, output: str | None = None) -> np.ndarray:
        expr = self.outputs[output or self.primary]
        missing = expr.free_vars() - set(env.keys())
        if missing:
            raise KeyError(f"rational program {self.name!r} missing inputs {missing}")
        return expr.eval(env)

    def eval_many(self, env: Env) -> dict[str, np.ndarray]:
        return {k: e.eval(env) for k, e in self.outputs.items()}

    def count_pieces(self) -> int:
        return self.outputs[self.primary].count_pieces()

    def specialize(self, bindings: Mapping[str, float]) -> "RationalProgram":
        """Partially evaluate every output with respect to ``bindings``.

        Specializing on the data parameters D is the compile step of a
        launch plan: the returned program depends only on the still-free
        inputs (typically the program parameters P), D-only subexpressions
        are folded to constants, and decision nodes whose conditions were
        decided by D are gone -- evaluating it over a candidate table does
        strictly less work than the general program.
        """
        return RationalProgram(
            name=f"{self.name}@" + ",".join(
                f"{k}={int(v)}" for k, v in sorted(bindings.items())),
            inputs=tuple(i for i in self.inputs if i not in bindings),
            outputs={k: e.specialize(bindings)
                     for k, e in self.outputs.items()},
            primary=self.primary,
        )

    # -- flowchart export (Fig. 2 style) -------------------------------------
    def to_flowchart(self) -> str:
        lines = [f"flowchart: {self.name}", f"inputs: {', '.join(self.inputs)}"]

        def walk(e: Expr, depth: int, tag: str) -> None:
            pad = "  " * depth
            if isinstance(e, Select):
                lines.append(f"{pad}[{tag}] decide: {e.cond.to_source()}")
                walk(e.if_true, depth + 1, "Y")
                walk(e.if_false, depth + 1, "N")
            else:
                src = e.to_source()
                if len(src) > 96:
                    src = src[:93] + "..."
                lines.append(f"{pad}[{tag}] compute: {src}")

        for k, e in self.outputs.items():
            lines.append(f"output {k}:")
            walk(e, 1, "*")
        return "\n".join(lines)
