"""KLARAPTOR core on Hopper: rational programs for launch-parameter choice.

The numpy-only layers (polynomials, rational functions, rational programs,
fitting) are carried over from the JAX package unchanged; the hardware side
(device model, kernel specs, performance model, generated drivers) targets
an NVIDIA H100.
"""

from .buckets import BucketLattice, pad_to, pow2_span
from .cache import (CacheEntry, DriverCache, PlanEntry, cache_key,
                    code_digest, default_cache, default_cache_dir,
                    spec_fingerprint)
from .collect import (BatchShard, CollectedData, batch_seed, collect,
                      collect_batch, default_probe_data,
                      from_reference_collected, merge_shards)
from .device_model import (H100, CudaEventTimer, DeviceModel, HardwareParams,
                           HopperModel, ProbeBatch, RowProbe, TrafficOperand,
                           TrafficTable, roofline_times)
from .device_plan import (BucketedDispatch, DevicePlanTable,
                          build_bucketed_dispatch, pack_shape32)
from .driver import (ChoiceEvent, DriverProgram, WarmStartSummary,
                     choose_or_default, dkey, fit_tile, get_choice_listener,
                     get_driver, local_hw, memo_key, register_driver,
                     registry, set_choice_listener, set_decision_memo,
                     warm_start_from_cache)
from .fitting import FitResult, fit_auto, fit_polynomial, fit_rational
from .kernel_spec import (CandidateTable, GridAxis, KernelSpec, Operand,
                          SpecError, flash_attention_spec, flash_probe_data,
                          gmm_probe_data, matmul_spec, moe_gmm_spec,
                          polybench_suite, ssd_probe_data, ssd_scan_spec)
from .occupancy import cuda_occupancy_program
from .perf_model import LOW_LEVEL_METRICS, build_time_program
from .plan import (LaunchPlanTable, compile_plan, lattice, pack_shape,
                   plan_key, precompile_plans)
from .polynomial import Polynomial, design_matrix, monomial_exponents
from .rational import RationalFunction
from .rational_program import (BinOp, Ceil, Const, Expr, Fitted, Floor, Max,
                               Min, RationalProgram, Select, Var, ceil_div,
                               const, floor_div, specialize_expr, var)
from .step_plan import (KernelRequest, StepPlan, active_step_plan,
                        build_step_plan, use_step_plan)
from .tuner import (BuildResult, Klaraptor, exhaustive_pass,
                    exhaustive_search, fitresult_from_json, search_best,
                    selection_ratio)

__all__ = [
    "BucketLattice", "pad_to", "pow2_span",
    "CacheEntry", "DriverCache", "PlanEntry", "cache_key", "code_digest",
    "default_cache", "default_cache_dir", "spec_fingerprint",
    "BatchShard", "CollectedData", "batch_seed", "collect", "collect_batch",
    "default_probe_data", "from_reference_collected", "merge_shards",
    "H100", "CudaEventTimer", "DeviceModel", "HardwareParams", "HopperModel",
    "ProbeBatch", "RowProbe", "TrafficOperand", "TrafficTable",
    "roofline_times",
    "BucketedDispatch", "DevicePlanTable", "build_bucketed_dispatch",
    "pack_shape32",
    "ChoiceEvent", "DriverProgram", "WarmStartSummary", "choose_or_default",
    "dkey", "fit_tile", "get_choice_listener", "get_driver", "local_hw",
    "memo_key", "register_driver", "registry", "set_choice_listener",
    "set_decision_memo", "warm_start_from_cache",
    "FitResult", "fit_auto", "fit_polynomial", "fit_rational",
    "CandidateTable", "GridAxis", "KernelSpec", "Operand", "SpecError",
    "flash_attention_spec", "flash_probe_data", "gmm_probe_data",
    "matmul_spec", "moe_gmm_spec", "polybench_suite", "ssd_probe_data",
    "ssd_scan_spec",
    "cuda_occupancy_program",
    "LOW_LEVEL_METRICS", "build_time_program",
    "LaunchPlanTable", "compile_plan", "lattice", "pack_shape", "plan_key",
    "precompile_plans",
    "Polynomial", "design_matrix", "monomial_exponents",
    "RationalFunction",
    "BinOp", "Ceil", "Const", "Expr", "Fitted", "Floor", "Max", "Min",
    "RationalProgram", "Select", "Var", "ceil_div", "const", "floor_div",
    "specialize_expr", "var",
    "KernelRequest", "StepPlan", "active_step_plan", "build_step_plan",
    "use_step_plan",
    "BuildResult", "Klaraptor", "exhaustive_pass", "exhaustive_search",
    "fitresult_from_json", "search_best", "selection_ratio",
]
