"""The port's tune -> choose -> launch loop, end to end on the CPU.

The device oracle is ``HopperModel``, the analytic H100 stand-in: a CPU
timing of the plain matmul would be flat in (bm, bn, bk).  The driver probes
m, n, k <= 1024 only and must choose well at sizes it never saw.

The configs the port chooses are *not* compared with the reference's: the
two packages model different hardware (an H100's shared memory, registers
and CTA waves against a TPU's VMEM pipeline) by design, so their optima
differ.  What is compared is the output of the tuned op.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro_torch.core import (H100, HopperModel, Klaraptor, build_time_program,
                              choose_or_default, matmul_spec, registry,
                              selection_ratio)
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def built():
    registry.clear()
    oracle = HopperModel(noise=0.04, seed=7)
    spec = matmul_spec(dtype_bytes=2)
    build = Klaraptor(oracle, device="cpu", cache=False).build_driver(
        spec, repeats=2, max_configs_per_size=24)
    yield spec, oracle, build
    registry.clear()


def test_probes_only_small_sizes(built):
    _, _, build = built
    cols = build.collected.columns
    assert max(int(cols[d].max()) for d in ("m", "n", "k")) <= 1024
    assert build.collected.n_probe_executions > 0
    assert set(build.fits) == {"mem_step", "cmp_step", "ovh_step"}


@pytest.mark.parametrize("n", [2048, 4096, 8192])
def test_selection_ratio_on_unseen_sizes(built, n):
    spec, oracle, build = built
    r = selection_ratio(spec, oracle, build.driver,
                        {"m": n, "n": n, "k": n}, H100)
    assert r["ratio"] >= 0.85, r


@pytest.mark.parametrize("D", [
    {"m": 256, "n": 512, "k": 1024}, {"m": 4096, "n": 2048, "k": 2048},
    {"m": 4096, "n": 128256, "k": 2048}, {"m": 4096, "n": 512, "k": 8192},
])
def test_candidates_obey_hopper_limits(built, D):
    spec, _, build = built
    table = spec.candidates(D, H100)
    assert len(table) > 0
    tt = spec.traffic_table(D, table, H100)
    assert np.all(tt.stage_bytes <= H100.smem_per_block_optin)
    assert np.all(tt.threads >= 32) and np.all(tt.threads <= 1024)
    assert np.all(tt.threads * spec.regs_per_thread <= H100.regs_per_sm)
    assert np.all(tt.blocks_per_sm >= 1)
    for p, d in (("bm", "m"), ("bn", "n"), ("bk", "k")):
        assert np.all(D[d] % table[p] == 0)
        assert np.all(table[p] % spec.alignment(p) == 0)
    # The generated driver enumerates exactly the spec's feasible set.
    gen = build.driver.candidates(D)
    for p in spec.program_params:
        np.testing.assert_array_equal(gen[p], table[p])


def test_generated_estimate_is_the_time_program(built):
    spec, _, build = built
    D = {"m": 4096, "n": 8192, "k": 2048}
    table = spec.candidates(D, H100)
    program = build_time_program(
        spec, {m: f.function for m, f in build.fits.items()}, H100)
    env = {**{d: float(v) for d, v in D.items()}, **table.columns}
    np.testing.assert_allclose(build.driver.estimate_batch(D, table.columns),
                               program.eval(env), rtol=1e-12)


def test_choose_or_default_precedence(built):
    _, _, build = built
    default = {"bm": 8, "bn": 8, "bk": 8}
    D = {"m": 2048, "n": 4096, "k": 1024}
    kernel = build.driver.kernel
    assert choose_or_default(kernel, D, default) == build.driver.choose(D)
    assert choose_or_default("matmul_unregistered", D, default) == default
    # An infeasible shape falls back to the default, not an error.
    assert choose_or_default(kernel, {"m": 12, "n": 20, "k": 36},
                             default) == default
    pinned = {"bm": 64, "bn": 64, "bk": 64}
    registry.note_override(kernel, H100.name, D, pinned)
    try:
        assert choose_or_default(kernel, D, default) == pinned
        other = {"m": 1024, "n": 1024, "k": 1024}
        assert choose_or_default(kernel, other, default) == \
            build.driver.choose(other)
    finally:
        registry.invalidate_kernel(kernel)
        registry.register(build.driver)


def test_tuned_cpu_matmul_matches_reference_tuned_matmul():
    from repro.core import Klaraptor as RefKlaraptor
    from repro.core import V5eSimulator
    from repro.core import matmul_spec as ref_matmul_spec
    from repro.core import registry as ref_registry
    from repro.kernels import ops as ref_ops

    prev = ref_registry.get("matmul_b32")
    RefKlaraptor(V5eSimulator(seed=1), cache=False).build_driver(
        ref_matmul_spec(dtype_bytes=4), repeats=1, max_configs_per_size=8)
    Klaraptor(HopperModel(seed=1), device="cpu", cache=False).build_driver(
        matmul_spec(dtype_bytes=4), repeats=1, max_configs_per_size=8)
    try:
        rng = np.random.RandomState(21)
        xa = (rng.randn(128, 512) * 0.5).astype(np.float32)
        ya = (rng.randn(512, 256) * 0.5).astype(np.float32)
        expected = ref_ops.matmul(jnp.asarray(xa), jnp.asarray(ya),
                                  use_pallas=True, interpret=True)
        out = ops.matmul(torch.from_numpy(xa), torch.from_numpy(ya))
        assert registry.get("matmul_b32") is not None
        np.testing.assert_allclose(out.numpy(), np.asarray(expected),
                                   atol=2e-4, rtol=2e-4)
    finally:
        if prev is None:
            ref_registry.invalidate_kernel("matmul_b32")
        else:
            ref_registry.register(prev)
        registry.clear()


def test_default_oracle_needs_a_card(monkeypatch):
    with pytest.raises(ValueError):
        Klaraptor(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Klaraptor()


def test_port_imports_neither_jax_nor_repro():
    code = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(" ".join(sorted(m for m in sys.modules if m.startswith("repro_torch"))))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    assert len(walked) >= 30
    for sub in ("core", "search", "kernels", "models", "configs", "launch",
                "serving", "introspect", "benchmarks", "examples", "trace",
                "telemetry", "obs"):
        assert f"repro_torch.{sub}" in walked, sub
