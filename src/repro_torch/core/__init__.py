"""KLARAPTOR core on Hopper: rational programs for launch-parameter choice.

The numpy-only layers (polynomials, rational functions, rational programs,
fitting) are carried over from the JAX package unchanged; the hardware side
(device model, kernel specs, performance model, generated drivers) targets
an NVIDIA H100.
"""

from .collect import (BatchShard, CollectedData, batch_seed, collect,
                      collect_batch, default_probe_data,
                      from_reference_collected, merge_shards)
from .device_model import (H100, CudaEventTimer, DeviceModel, HardwareParams,
                           HopperModel, ProbeBatch, RowProbe, TrafficOperand,
                           TrafficTable, roofline_times)
from .driver import (DriverProgram, choose_or_default, dkey, fit_tile,
                     register_driver, registry)
from .fitting import FitResult, fit_auto, fit_polynomial, fit_rational
from .kernel_spec import (CandidateTable, GridAxis, KernelSpec, Operand,
                          SpecError, flash_attention_spec, flash_probe_data,
                          matmul_spec, ssd_probe_data, ssd_scan_spec)
from .occupancy import cuda_occupancy_program
from .perf_model import LOW_LEVEL_METRICS, build_time_program
from .polynomial import Polynomial, design_matrix, monomial_exponents
from .rational import RationalFunction
from .rational_program import (BinOp, Ceil, Const, Expr, Fitted, Floor, Max,
                               Min, RationalProgram, Select, Var, ceil_div,
                               const, floor_div, specialize_expr, var)
from .tuner import (BuildResult, Klaraptor, exhaustive_search,
                    fitresult_from_json, selection_ratio)

__all__ = [
    "BatchShard", "CollectedData", "batch_seed", "collect", "collect_batch",
    "default_probe_data", "from_reference_collected", "merge_shards",
    "H100", "CudaEventTimer", "DeviceModel", "HardwareParams", "HopperModel",
    "ProbeBatch", "RowProbe", "TrafficOperand", "TrafficTable",
    "roofline_times",
    "DriverProgram", "choose_or_default", "dkey", "fit_tile",
    "register_driver", "registry",
    "FitResult", "fit_auto", "fit_polynomial", "fit_rational",
    "CandidateTable", "GridAxis", "KernelSpec", "Operand", "SpecError",
    "flash_attention_spec", "flash_probe_data", "matmul_spec",
    "ssd_probe_data", "ssd_scan_spec",
    "cuda_occupancy_program",
    "LOW_LEVEL_METRICS", "build_time_program",
    "Polynomial", "design_matrix", "monomial_exponents",
    "RationalFunction",
    "BinOp", "Ceil", "Const", "Expr", "Fitted", "Floor", "Max", "Min",
    "RationalProgram", "Select", "Var", "ceil_div", "const", "floor_div",
    "specialize_expr", "var",
    "BuildResult", "Klaraptor", "exhaustive_search", "fitresult_from_json",
    "selection_ratio",
]
