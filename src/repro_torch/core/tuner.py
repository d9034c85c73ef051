"""KLARAPTOR facade: build drivers (compile time) and evaluate them.

``Klaraptor.build_driver`` runs the three compile-time steps of Section IV
(collect -> fit -> codegen) for one kernel spec against a device oracle and
returns a ready, registered ``DriverProgram``.  Builds write through the
persistent driver cache (core/cache.py): a later process asking for the same
spec, card and build settings (the oracle's fingerprint among them) gets the
stored driver back without one probe.

``exhaustive_search`` is the paper's comparison baseline (Table I "Best
Config." column): time *every* feasible configuration at the actual data
size in one batched oracle pass and take the argmin; ``search_best`` is its
budgeted online alternative (``search.run_search``).  ``selection_ratio``
scores a driver the way Fig. 1 does: best_time / chosen_time (>= 0.85 is
"good").
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Mapping, Sequence

import numpy as np
import torch

from .cache import (CacheEntry, DriverCache, cache_key, code_digest,
                    default_cache)
from .codegen import generate_driver_source
from .collect import CollectedData, collect
from .device_model import CudaEventTimer, DeviceModel, HardwareParams
from .driver import DriverProgram, register_driver
from .fitting import FitResult, fit_auto
from .kernel_spec import CandidateTable, KernelSpec
from .perf_model import LOW_LEVEL_METRICS
from .rational import RationalFunction
from ..trace import trace_span

__all__ = ["BuildResult", "Klaraptor", "exhaustive_pass", "exhaustive_search",
           "fitresult_from_json", "search_best", "selection_ratio"]

logger = logging.getLogger(__name__)

Dims = Mapping[str, int]


@dataclass
class BuildResult:
    driver: DriverProgram
    fits: dict[str, FitResult]
    collected: CollectedData
    build_wall_seconds: float
    probe_device_seconds: float
    from_cache: bool = False

    def fit_report(self) -> str:
        origin = " (cached)" if self.from_cache else ""
        lines = [f"driver build for {self.driver.kernel}{origin}:"]
        for m, f in self.fits.items():
            lines.append(
                f"  {m}: deg(num)={f.num_bounds} deg(den)={f.den_bounds} "
                f"params={f.n_params} rel_err={f.rel_error:.3f} "
                f"cv_err={f.cv_error:.3f}")
        lines.append(
            f"  probes={self.collected.n_probe_executions} "
            f"device_s={self.probe_device_seconds:.4f} "
            f"wall_s={self.build_wall_seconds:.2f}")
        return "\n".join(lines)


def _fits_to_json(fits: Mapping[str, FitResult]) -> dict:
    return {m: {
        "function": f.function.to_json(),
        "rel_error": f.rel_error,
        "cv_error": f.cv_error,
        "num_bounds": list(f.num_bounds),
        "den_bounds": list(f.den_bounds),
        "n_params": f.n_params,
        "condition_number": f.condition_number,
    } for m, f in fits.items()}


def fitresult_from_json(raw: Mapping) -> dict[str, FitResult]:
    """Fits in the JSON form the JAX package stores them in (its driver
    cache's ``fits`` field) as the port's ``FitResult``s."""
    return {m: FitResult(
        function=RationalFunction.from_json(f["function"]),
        rel_error=f["rel_error"],
        cv_error=f["cv_error"],
        num_bounds=tuple(f["num_bounds"]),
        den_bounds=tuple(f["den_bounds"]),
        n_params=f["n_params"],
        condition_number=f["condition_number"],
    ) for m, f in raw.items()}


class Klaraptor:
    """The tool: compile-time driver construction + runtime selection.

    With no oracle it times the port's kernels on the card
    (``CudaEventTimer``) and raises if there is none; on the CPU a caller
    passes an oracle (``HopperModel``) and ``device="cpu"`` explicitly.
    ``cache``: None for the default driver cache, False for none, or a
    ``DriverCache``.
    """

    # The cache-write warning is given once per process: an unwritable
    # cache directory is one diagnosis, not one per build.
    _cache_write_warned = False

    def __init__(self, oracle: DeviceModel | None = None, *,
                 device: str | torch.device = "cuda",
                 hw: HardwareParams | None = None,
                 cache: DriverCache | None | bool = None):
        self.hw = hw or (oracle.hw if oracle is not None
                         else HardwareParams.from_device(device))
        self.oracle = oracle if oracle is not None else \
            CudaEventTimer(self.hw, device=device)
        if cache is False:
            self.cache: DriverCache | None = None
        elif cache is None:
            self.cache = default_cache()
        else:
            self.cache = cache

    def build_driver(
        self,
        spec: KernelSpec,
        probe_data: Sequence[Dims] | None = None,
        repeats: int = 3,
        max_configs_per_size: int = 32,
        seed: int = 0,
        register: bool = True,
        max_num_degree: int = 2,
        max_den_degree: int = 2,
        strategy=None,
        budget=None,
        use_cache: bool = True,
        cache_version: int = 0,
        shard_rows: int | None = None,
        data: CollectedData | None = None,
    ) -> BuildResult:
        """Collect -> fit -> codegen one driver, through the driver cache.

        A cache hit (same spec, hardware, settings and oracle fingerprint)
        returns the stored driver with ``from_cache=True`` and no probe;
        ``use_cache=False`` skips the read but still writes.  A miss builds
        and writes the driver as generation ``cache_version``; a failed
        write warns once and does not fail the build.

        ``data`` supplies an already-collected dataset -- the tuning farm's
        write-through: nothing is probed, and since the other arguments
        still describe how the data was collected, the driver lands under
        the key the single-process build computes.  ``shard_rows`` selects
        chunk-seeded probe noise (see ``collect``) and is part of the key
        when set.
        """
        from ..search import resolve_strategy

        t0 = time.perf_counter()
        if data is not None and data.spec_name != spec.name:
            raise ValueError(
                f"supplied data is for {data.spec_name!r}, not {spec.name!r}")
        key = None
        if self.cache is not None:
            hyper = {
                "repeats": repeats,
                "max_configs_per_size": max_configs_per_size,
                "seed": seed,
                "max_num_degree": max_num_degree,
                "max_den_degree": max_den_degree,
                "probe_data": [sorted(d.items()) for d in probe_data]
                if probe_data is not None else None,
                "oracle": self.oracle.fingerprint(),
                "strategy": resolve_strategy(strategy).fingerprint(),
                "budget": budget.fingerprint() if budget is not None
                else None,
            }
            # folded in only when set, so earlier builds keep their keys
            if shard_rows is not None:
                hyper["shard_rows"] = int(shard_rows)
            key = cache_key(spec, self.hw, hyper)
        with trace_span("build_driver", kernel=spec.name) as bsp:
            entry = self.cache.get(spec.name, key) \
                if key is not None and use_cache else None
            if entry is not None:
                driver = DriverProgram.from_source(
                    spec.name, entry.source, self.hw,
                    tuning_version=entry.tuning_version, code=entry.code)
                if register:
                    register_driver(driver)
                bsp.set(from_cache=True)
                return BuildResult(
                    driver=driver,
                    fits=fitresult_from_json(entry.fits),
                    collected=CollectedData.empty(spec),
                    build_wall_seconds=time.perf_counter() - t0,
                    probe_device_seconds=0.0,
                    from_cache=True,
                )
            if data is None:
                data = collect(spec, self.oracle, probe_data=probe_data,
                               hw=self.hw, repeats=repeats,
                               max_configs_per_size=max_configs_per_size,
                               seed=seed, strategy=strategy, budget=budget,
                               shard_rows=shard_rows)
            fits: dict[str, FitResult] = {}
            with trace_span("fit", kernel=spec.name,
                            n_samples=len(data)) as fsp:
                for metric in LOW_LEVEL_METRICS:
                    vars_ = spec.metric_fit_vars(metric)
                    X, y = data.matrix(metric, vars_)
                    fits[metric] = fit_auto(X, y, vars_,
                                            max_num_degree=max_num_degree,
                                            max_den_degree=max_den_degree)
                fsp.set(rel_error={m: round(f.rel_error, 6)
                                   for m, f in fits.items()})
            with trace_span("codegen", kernel=spec.name):
                source = generate_driver_source(
                    spec, {m: f.function for m, f in fits.items()}, self.hw)
                driver = DriverProgram.from_source(
                    spec.name, source, self.hw, tuning_version=cache_version,
                    code=code_digest(spec))
            if register:
                register_driver(driver)
            if key is not None:
                self._cache_put(spec, key, source, fits, cache_version)
            bsp.set(from_cache=False,
                    probe_device_seconds=data.probe_device_seconds)
            return BuildResult(
                driver=driver,
                fits=fits,
                collected=data,
                build_wall_seconds=time.perf_counter() - t0,
                probe_device_seconds=data.probe_device_seconds,
            )

    def _cache_put(self, spec: KernelSpec, key: str, source: str,
                   fits: dict[str, FitResult], tuning_version: int) -> None:
        """Write one build through; an unwritable cache warns once."""
        try:
            self.cache.put(CacheEntry(
                kernel=spec.name, key=key, source=source,
                fits=_fits_to_json(fits), code=code_digest(spec),
                created_at=time.time(), hw_name=self.hw.name,
                tuning_version=tuning_version))
        except OSError as e:
            if not Klaraptor._cache_write_warned:
                Klaraptor._cache_write_warned = True
                logger.warning(
                    "driver cache write failed (%s) at %s for kernel %s; "
                    "builds will not persist, so every process probes "
                    "anew (point KLARAPTOR_CACHE_DIR at a writable "
                    "directory)", e, self.cache.path(spec.name, key),
                    spec.name)


def exhaustive_pass(
    spec: KernelSpec,
    device: DeviceModel,
    D: Dims,
    hw: HardwareParams,
):
    """Every feasible config's time at data size D in one batched oracle
    pass: (candidate table, times).  Raises ValueError on an empty table."""
    table = spec.candidates(D, hw)
    if not len(table):
        raise ValueError(f"no feasible configuration for {spec.name} at {D}")
    return table, device.true_time_batch(spec.traffic_table(D, table, hw))


def exhaustive_search(
    spec: KernelSpec,
    device: DeviceModel,
    D: Dims,
    hw: HardwareParams,
) -> tuple[dict[str, int], float, int, float]:
    """Ground-truth argmin over every feasible config at data size D.

    One batched oracle evaluation over the whole candidate table
    (``exhaustive_pass``).  Returns (best_P, best_time, n_evaluations,
    total_device_seconds).
    """
    table, times = exhaustive_pass(spec, device, D, hw)
    best = int(np.argmin(times))
    return (table.row(best), float(times[best]), len(table),
            float(np.sum(times)))


def search_best(
    spec: KernelSpec,
    device: DeviceModel | None,
    D: Dims,
    strategy=None,
    budget=None,
    hw: HardwareParams | None = None,
    seed: int = 0,
):
    """Budget-aware online search at the actual data size D.

    The cheap alternative to ``exhaustive_search`` for untuned kernels: a
    search strategy (name or instance; default stratified ``random``)
    probes the candidate table under a hard ``SearchBudget`` (default ~25%
    of a one-repeat exhaustive pass) and the observed argmin is returned as
    a ``SearchResult`` (``.best_config`` is the chosen P).  ``device`` is
    the oracle: None times the port's kernel on the card
    (``CudaEventTimer``, which raises without one); on the CPU a caller
    passes one (``HopperModel``).  ``hw`` defaults to the oracle's.
    """
    from ..search import run_search

    if device is None:
        device = CudaEventTimer(hw)
    return run_search(spec, device, D, strategy=strategy, budget=budget,
                      hw=hw, seed=seed)


def selection_ratio(
    spec: KernelSpec,
    device: DeviceModel,
    driver: DriverProgram,
    D: Dims,
    hw: HardwareParams,
) -> dict:
    """Fig. 1 metric: best_time / chosen_time at data size D (1.0 = optimal)."""
    chosen = driver.choose(D)
    one = CandidateTable.from_rows(spec.program_params, [chosen])
    t_chosen = float(device.true_time_batch(spec.traffic_table(D, one, hw))[0])
    best_P, t_best, n, _ = exhaustive_search(spec, device, D, hw)
    return {
        "kernel": spec.name,
        "D": dict(D),
        "chosen": chosen,
        "chosen_time_s": t_chosen,
        "best": best_P,
        "best_time_s": t_best,
        "ratio": t_best / max(t_chosen, 1e-300),
        "n_configs": n,
    }
