"""Auto-registered kernels: introspected specs wired into the runtime.

``auto_register`` is the one-call path from "I wrote a CUDA kernel" to "the
KLARAPTOR pipeline serves it": it introspects the kernel into a
:class:`KernelSpec` (derive.py) and records an :class:`AutoKernel` in a
process-wide table.  The AutoKernel is the glue the other layers use:

  * ``choose(D)``        -- launch parameters through the standard
    ``choose_or_default`` dispatch (override > driver > default), the same
    path ``kernels/ops.py`` uses for hand-specced kernels;
  * ``ensure_driver``    -- the registered driver, else a full collect ->
    fit -> codegen build against a device oracle (``CudaEventTimer`` on the
    card, ``HopperModel`` on the CPU).  The port has no artifact cache yet
    (ROADMAP Queue A, 'Rest of the tuning pipeline'), so it builds whenever
    no driver is registered in this process;
  * ``fit_config``       -- snap a chosen config onto an actual shape with
    the *derived* granularities (parsed back out of the synthesized
    ``"p % g == 0"`` constraints) and the derived ragged axes;
  * ``plan_envelope``    -- a traffic lattice over the data parameters, for
    the launch plans the port does not have yet.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import torch

from ..core.device_model import DeviceModel
from ..core.driver import (DriverProgram, choose_or_default, fit_tile,
                           registry)
from ..core.kernel_spec import KernelSpec
from .derive import derive_kernel
from .gridspec import GridSpec
from .trace import Capture, CudaKernel

__all__ = ["AutoKernel", "auto_register", "get_auto", "auto_kernels"]

Dims = Mapping[str, int]


@dataclass
class AutoKernel:
    """One introspected kernel, ready for driver dispatch and tuning.
    ``capture`` holds its compiled attributes and fingerprint."""

    spec: KernelSpec
    grid_spec: GridSpec
    kernel: CudaKernel
    capture: Capture
    # The collect -> fit -> codegen result of ``ensure_driver``'s last build
    # (probes and fit errors), None until it builds one.
    build: object = field(default=None, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def defaults(self) -> dict[str, int]:
        """Static fallback config: the GridSpec's, else mid-grid candidates."""
        if self.grid_spec.defaults:
            return dict(self.grid_spec.defaults)
        out = {}
        for p in self.spec.program_params:
            cand = self.spec.default_candidates(p)
            out[p] = int(cand[len(cand) // 2])
        return out

    def alignments(self) -> dict[str, int]:
        """Derived per-parameter granularity, from the synthesized
        ``"p % g == 0"`` constraints (1 where there is none)."""
        return {p: self.spec.alignment(p) for p in self.spec.program_params}

    def fit_config(self, config: Dims, dims: Dims) -> dict[str, int]:
        """Snap a chosen config onto the actual extents ``dims`` (data param
        -> extent) at the *derived* granularity: a tile of a ragged axis
        (the kernel masks its partial last block) is kept, at most the
        extent rounded up to the granularity; any other tile becomes a
        divisor of its extent (the shared ``core.driver.fit_tile``)."""
        align = self.alignments()
        out = dict(config)
        for a in self.spec.grid:
            p = a.block
            if p is None or not isinstance(a.data, str) or a.data not in dims:
                continue
            size, g = int(dims[a.data]), align.get(p, 1)
            if a.ragged:
                out[p] = min(int(out[p]), -(-size // g) * g)
            else:
                out[p] = fit_tile(size, int(out[p]), g)
        return out

    def choose(self, D: Dims) -> dict[str, int]:
        """Launch parameters via the standard dispatch chain."""
        return choose_or_default(self.name, D, self.defaults)

    def probe_data(self, sizes: Sequence[int] = (256, 512, 1024)
                   ) -> list[dict[str, int]]:
        """The probe grid: every data parameter swept over ``sizes``, or
        over its GridSpec probe hint where it has one (the reference's
        ``default_probe_data`` rule)."""
        axes = [self.grid_spec.probe_hints.get(d, tuple(sizes))
                for d in self.spec.data_params]
        return [dict(zip(self.spec.data_params, map(int, combo)))
                for combo in itertools.product(*axes)]

    def ensure_driver(self, device: DeviceModel | None = None,
                      **build_kwargs) -> DriverProgram:
        """The registered driver, or one built against ``device`` (None:
        ``CudaEventTimer`` on the card) on ``probe_data()`` unless the
        caller passes its own.  There is no artifact cache yet, so every
        process without a registered driver builds anew."""
        drv = registry.get(self.name)
        if drv is not None:
            return drv
        from ..core.tuner import Klaraptor

        build_kwargs.setdefault("probe_data", self.probe_data())
        self.build = Klaraptor(device).build_driver(self.spec, **build_kwargs)
        return self.build.driver

    def plan_envelope(self, sizes: Sequence[int] = (256, 512, 1024, 2048,
                                                    4096)) -> dict:
        """Per-data-param value lists over which plans would be compiled:
        the GridSpec's probe hints where it has them, else ``sizes``."""
        env = {}
        for d in self.spec.data_params:
            hint = self.grid_spec.probe_hints.get(d)
            env[d] = list(hint) if hint is not None else list(sizes)
        return env


_AUTO: dict[str, AutoKernel] = {}


def auto_register(kernel: CudaKernel, grid_spec: GridSpec, *,
                  device: str | torch.device = "cuda") -> AutoKernel:
    """Introspect ``kernel`` and register it for tuned dispatch.

    ``device`` says where the registers come from: the compiled kernel on a
    CUDA device, the ``__launch_bounds__`` cap on ``"cpu"``.  Idempotent per
    spec name, spec and defaults: re-registering an identical kernel returns
    the existing AutoKernel; a changed kernel, register count or GridSpec
    policy under the same name replaces it.
    """
    spec, cap = derive_kernel(kernel, grid_spec, device=device)
    existing = _AUTO.get(spec.name)
    if existing is not None and existing.spec == spec and \
            existing.grid_spec.defaults == grid_spec.defaults:
        return existing
    ak = AutoKernel(spec=spec, grid_spec=grid_spec, kernel=kernel,
                    capture=cap)
    _AUTO[spec.name] = ak
    return ak


def get_auto(name: str) -> AutoKernel | None:
    return _AUTO.get(name)


def auto_kernels() -> dict[str, AutoKernel]:
    """Snapshot of every auto-registered kernel in this process."""
    return dict(_AUTO)
