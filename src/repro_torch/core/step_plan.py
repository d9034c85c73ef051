"""Per-step launch plans: every config of one serving step, resolved once,
served from a frozen dict.

A serving step that launches N tuned kernels pays N ``choose_or_default``
calls.  A ``StepPlan`` moves the whole set of decisions to step-build time:
the caller declares the launches one prefill or decode step makes
(``KernelRequest``s; ``models.transformer.decode_kernel_requests`` derives
them from a model config), and ``build_step_plan`` resolves all of them up
front -- pinned overrides and compiled plans first, then one ``choose_many``
per kernel over its remaining shapes, then each request's default.  Inside
the step, ``StepPlan.resolve`` is the decision: one int compare and one
dict probe, no registry traffic.

A plan is valid for one registry generation, the decision memo's contract:
it freezes ``registry.generation`` at build time and ``resolve`` serves
nothing (returns None) once the registry moves on -- a driver swapped, a
plan registered, an override pinned -- and the ops fall through to
``choose_or_default``, where the new state, an override first, wins.  That
fall-through is what makes "pinned override > step plan > registry" hold
without the step plan checking overrides itself.

``use_step_plan`` installs a plan as ambient context (a contextvar), so
model code needs no plumbing: ``kernels.ops`` consults the active plan
before the registry.  PyTorch runs eagerly, so every op call resolves on
the host at launch time (the JAX package decides once, while tracing):
the step plan's probe is on the path of every launch of the step.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np

from ..trace import trace_span
from .device_model import HardwareParams
from .driver import Dims, dkey, get_driver, registry

__all__ = ["KernelRequest", "StepPlan", "active_step_plan",
           "build_step_plan", "use_step_plan"]


@dataclass(frozen=True)
class KernelRequest:
    """One kernel launch a step will make: the kernel, its data parameters
    (as the op builds them, after any padding to the kernel's granule) and
    the config it takes when nothing tuned covers it (the op's own
    default, so a step served by a step plan and one served by the
    registry launch the same tiles)."""

    kernel: str
    D: tuple          # dkey(D): sorted (name, value) pairs
    default: tuple    # dkey(config)

    @classmethod
    def make(cls, kernel: str, D: Dims,
             default: Mapping[str, int]) -> "KernelRequest":
        return cls(kernel=kernel, D=dkey(D), default=dkey(default))


@dataclass(frozen=True)
class StepPlan:
    """Frozen (kernel, shape) -> config map of one step.

    ``resolve`` returns the stored config dict itself (callers read it and
    never change it), or None when the plan is stale or has no entry; the
    caller then falls through to ``choose_or_default``.
    """

    hw_name: str | None    # None: each kernel's ``registry.hw_name``
    generation: int
    table: dict = field(repr=False)    # (kernel, dkey(D)) -> config
    sources: dict = field(repr=False)  # (kernel, dkey(D)) -> source

    def stale(self) -> bool:
        return registry.generation != self.generation

    def resolve(self, kernel: str, D: Dims) -> dict | None:
        if registry.generation != self.generation:
            return None
        return self.table.get((kernel, dkey(D)))

    def __len__(self) -> int:
        return len(self.table)

    def describe(self) -> dict:
        """Entry count and the count of entries per source."""
        by_source: dict[str, int] = {}
        for s in self.sources.values():
            by_source[s] = by_source.get(s, 0) + 1
        return {"entries": len(self.table), "generation": self.generation,
                "hw_name": self.hw_name, "sources": by_source}


def build_step_plan(requests: Iterable[KernelRequest],
                    hw: HardwareParams | None = None) -> StepPlan:
    """Resolve every request into one frozen ``StepPlan``.

    Each request is resolved as ``choose_or_default`` would: a pinned
    override, then the kernel's compiled plan, then the registered driver
    -- one ``choose_many`` per kernel over its distinct shapes, whose
    decisions join the kernel's plan as ``choose_or_default``'s do --,
    then the request's default.  Only registered drivers are asked (a
    request carries no spec to read the driver cache by).  Without ``hw``
    each kernel's overrides and plans are read under
    ``registry.hw_name(kernel)``, as ``choose_or_default`` reads them, and
    the plan's ``hw_name`` is None.

    The registry's generation is taken *before* resolving, so a mutation
    that lands meanwhile makes the plan stale from birth.
    """
    generation = registry.generation
    reqs = list(requests)
    with trace_span("build_step_plan", n_requests=len(reqs)) as span:
        plan = _build_step_plan(reqs, hw, generation)
        span.set(entries=len(plan.table), generation=plan.generation)
    return plan


def _build_step_plan(requests: list, hw: HardwareParams | None,
                     generation: int) -> StepPlan:
    table: dict = {}
    sources: dict = {}
    pending: dict[str, list[KernelRequest]] = {}
    for r in requests:
        key = (r.kernel, r.D)
        if key in table:
            continue
        D = dict(r.D)
        hw_name = hw.name if hw is not None else registry.hw_name(r.kernel)
        override = registry.override(r.kernel, hw_name, D)
        if override is not None:
            table[key] = dict(override)
            sources[key] = "override"
            continue
        plan_cfg = registry.plan_lookup(r.kernel, hw_name, D)
        if plan_cfg is not None:
            table[key] = plan_cfg
            sources[key] = "plan"
            continue
        pending.setdefault(r.kernel, []).append(r)
    for kernel, krs in pending.items():
        hw_name = hw.name if hw is not None else registry.hw_name(kernel)
        drv = get_driver(kernel)
        decided: dict[tuple, dict] = {}
        if drv is not None:
            shapes = [dict(r.D) for r in krs]
            try:
                cols = {d: np.asarray([s[d] for s in shapes], dtype=np.int64)
                        for d in drv.data_params}
                configs, ok = drv.choose_many(cols)
                for i, r in enumerate(krs):
                    if bool(ok[i]):
                        decided[r.D] = {p: int(configs[p][i])
                                        for p in drv.program_params}
            except (ValueError, KeyError, TypeError):
                decided = {}    # a driver of other data parameters
        for r in krs:
            key = (r.kernel, r.D)
            cfg = decided.get(r.D)
            if cfg is not None:
                table[key] = cfg
                sources[key] = "driver"
                registry.note_plan_fill(kernel, hw_name, dict(r.D), cfg,
                                        source_hash=drv.source_hash)
            else:
                table[key] = dict(r.default)
                sources[key] = "default"
    return StepPlan(hw_name=hw.name if hw is not None else None,
                    generation=generation, table=table,
                    sources=sources)


# A contextvar, not a module global: several engines in one process must
# not see each other's step plans.
_active_plan: contextvars.ContextVar[StepPlan | None] = \
    contextvars.ContextVar("active_step_plan", default=None)


def active_step_plan() -> StepPlan | None:
    return _active_plan.get()


@contextlib.contextmanager
def use_step_plan(plan: StepPlan | None):
    """Make ``plan`` the ambient step plan of the enclosed calls: the ops
    consult it before the registry.  None switches an outer plan off."""
    token = _active_plan.set(plan)
    try:
        yield plan
    finally:
        _active_plan.reset(token)
