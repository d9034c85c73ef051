"""GridSpecs for the hand-specced matmul and grouped matmul.

These declare what KLARAPTOR's users put in configuration files -- parameter
names, candidate grids, fit variables, defaults -- and nothing structural.
``spec_from_kernel`` over these must reproduce the port's hand-written specs
(``core/kernel_spec.py``: ``matmul_spec``, ``moe_gmm_spec``) behaviourally:
the same candidates, feasible set, traffic and chosen configs
(``tests/test_torch_introspect.py`` and ``chip_smoke.py`` hold that).
Dispatch keeps the hand specs; these exist as the ground-truth check that
introspection is faithful.  The flash-attention and SSD GridSpecs wait:
their ragged axes and P-dependent FLOPs need hints (ROADMAP Queue A).
"""

from __future__ import annotations

import torch

from ..core.kernel_spec import SIMT_CANDIDATES, SM90_CANDIDATES
from .gridspec import GridSpec

__all__ = ["EQUIV_SHAPES", "matmul_grid_spec", "moe_gmm_grid_spec",
           "tier1_pairs"]

_FIT = ("mem_step", "cmp_step", "ovh_step")

# The JAX package's representative shapes for the equivalence check
# (tests/test_introspect.py::EQUIV_SHAPES).
EQUIV_SHAPES = {
    "matmul_b16": [
        {"m": 512, "n": 512, "k": 512},
        {"m": 1024, "n": 1024, "k": 1024},
        {"m": 2048, "n": 1024, "k": 4096},
        {"m": 128, "n": 8192, "k": 1024},
        {"m": 4096, "n": 4096, "k": 2048},
        {"m": 8192, "n": 256, "k": 512},
        {"m": 2048, "n": 2048, "k": 2048},
        {"m": 256, "n": 1024, "k": 8192},
    ],
    "moe_gmm_b16": [
        {"e": 8, "g": 1024, "k": 2048, "n": 1024},
        {"e": 4, "g": 4096, "k": 1024, "n": 2048},
        {"e": 16, "g": 512, "k": 1024, "n": 1024},
        {"e": 2, "g": 2048, "k": 4096, "n": 512},
        {"e": 8, "g": 256, "k": 512, "n": 2048},
        {"e": 32, "g": 1024, "k": 1024, "n": 1536},
        {"e": 4, "g": 8192, "k": 2048, "n": 1024},
        {"e": 8, "g": 2048, "k": 2048, "n": 2048},
    ],
}


def _dtype(dtype_bytes: int) -> torch.dtype:
    return torch.bfloat16 if dtype_bytes == 2 else torch.float32


def _candidates(rows: str, dtype_bytes: int) -> dict[str, tuple[int, ...]]:
    """The tile values to tune over: the wgmma kernel's compiled sizes in
    bf16, the SIMT kernel's powers of two in f32."""
    if dtype_bytes == 2:
        return {rows: SM90_CANDIDATES["m"], "bn": SM90_CANDIDATES["n"],
                "bk": SM90_CANDIDATES["k"]}
    return {rows: SIMT_CANDIDATES["m"], "bn": SIMT_CANDIDATES["n"],
            "bk": SIMT_CANDIDATES["k"]}


def _defaults(rows: str, dtype_bytes: int) -> dict[str, int]:
    return {rows: 128, "bn": 128, "bk": 64 if dtype_bytes == 2 else 32}


def matmul_grid_spec(dtype_bytes: int = 2) -> GridSpec:
    dt = _dtype(dtype_bytes)
    return GridSpec(
        name=f"matmul_b{dtype_bytes * 8}",
        data_params=("m", "n", "k"),
        program_params=("bm", "bn", "bk"),
        make_args=lambda D: (((D["m"], D["k"]), dt), ((D["k"], D["n"]), dt)),
        param_candidates=_candidates("bm", dtype_bytes),
        fit_vars={m: ("bm", "bn", "bk") for m in _FIT},
        defaults=_defaults("bm", dtype_bytes),
    )


def moe_gmm_grid_spec(dtype_bytes: int = 2) -> GridSpec:
    dt = _dtype(dtype_bytes)
    return GridSpec(
        name=f"moe_gmm_b{dtype_bytes * 8}",
        data_params=("e", "g", "k", "n"),
        program_params=("bg", "bn", "bk"),
        make_args=lambda D: (((D["e"], D["g"], D["k"]), dt),
                             ((D["e"], D["k"], D["n"]), dt)),
        param_candidates=_candidates("bg", dtype_bytes),
        fit_vars={m: ("bg", "bn", "bk") for m in _FIT},
        probe_hints={"e": (2, 4)},
        defaults=_defaults("bg", dtype_bytes),
    )


def tier1_pairs():
    """(CUDA kernel, GridSpec, hand spec) for the bf16 matmul and grouped
    matmul."""
    from ..core.kernel_spec import matmul_spec, moe_gmm_spec
    from ..kernels.matmul import MATMUL
    from ..kernels.moe_gmm import MOE_GMM

    return [
        (MATMUL, matmul_grid_spec(), matmul_spec()),
        (MOE_GMM, moe_gmm_grid_spec(), moe_gmm_spec()),
    ]
