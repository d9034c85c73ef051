"""The port's driver cache: write-through, read-back in a fresh process,
what the build key covers, the stale-entry rule, the read-through of
``choose_or_default`` (only of entries built for the caller's spec under the
current kernel sources), the separation from the JAX package's entries, and
an unwritable directory.

Every test points ``KLARAPTOR_CACHE_DIR`` at its own empty directory and
builds on ``HopperModel`` (the analytic H100) on the CPU.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import textwrap

import pytest

from repro.core import Klaraptor as RefKlaraptor
from repro.core import V5eSimulator
from repro.core import matmul_spec as ref_matmul_spec
from repro.core import registry as ref_registry
from repro.core.cache import default_cache as ref_default_cache

from repro_torch.core import (H100, CacheEntry, DriverCache, HopperModel,
                              Klaraptor, cache_key, choose_or_default,
                              code_digest, default_cache, get_driver,
                              matmul_spec, registry, spec_fingerprint,
                              warm_start_from_cache)
from repro_torch.core import device_model as dm
from repro_torch.core import tuner as tuner_mod
from repro_torch.kernels import _build as kernel_build

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
SIZES = (1024, 2048, 4096, 8192, 16384)
BUILD = dict(repeats=2, max_configs_per_size=16)


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "cache"
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(d))
    registry.clear()
    yield str(d)
    registry.clear()


def _build(oracle=None, spec=None, register=False, **kw):
    oracle = oracle or HopperModel(noise=0.03, seed=5)
    return Klaraptor(oracle, device="cpu").build_driver(
        spec or matmul_spec(), register=register, **{**BUILD, **kw})


def _choices(driver):
    return {n: driver.choose({"m": n, "n": n, "k": n}) for n in SIZES}


def test_miss_writes_then_hit_probes_nothing(cache_dir):
    first = _build()
    assert not first.from_cache and first.collected.n_probe_executions > 0
    path = os.path.join(cache_dir, "repro_torch", "matmul_b16")
    assert len(os.listdir(path)) == 1
    second = _build()
    assert second.from_cache
    assert second.collected.n_probe_executions == 0
    assert second.probe_device_seconds == 0.0
    assert second.driver.source == first.driver.source
    assert _choices(second.driver) == _choices(first.driver)
    assert set(second.fits) == set(first.fits)
    assert "(cached)" in second.fit_report()
    # use_cache=False probes anew (and writes the same key again)
    third = _build(use_cache=False)
    assert not third.from_cache and third.collected.n_probe_executions > 0
    assert len(os.listdir(path)) == 1


def test_fresh_process_reads_the_driver(cache_dir):
    """A driver built here is read, not rebuilt, by a fresh process: zero
    probe executions and bit-identical choices at five sizes, through the
    build and through ``choose_or_default``'s read-through."""
    first = _build()
    expect = {str(n): c for n, c in _choices(first.driver).items()}
    code = textwrap.dedent(f"""
        import json
        from repro_torch.core import (HopperModel, Klaraptor,
                                      choose_or_default, matmul_spec,
                                      registry)
        assert registry.get("matmul_b16") is None
        read = {{str(n): choose_or_default(
            "matmul_b16", {{"m": n, "n": n, "k": n}}, {{"bm": -1}},
            spec=matmul_spec()) for n in {SIZES!r}}}
        build = Klaraptor(HopperModel(noise=0.03, seed=5),
                          device="cpu").build_driver(
            matmul_spec(), register=False, **{BUILD!r})
        print(json.dumps({{
            "from_cache": build.from_cache,
            "probes": build.collected.n_probe_executions,
            "choices": {{str(n): build.driver.choose(
                {{"m": n, "n": n, "k": n}}) for n in {SIZES!r}}},
            "read_through": read}}))
    """)
    env = dict(os.environ, PYTHONPATH=SRC, KLARAPTOR_CACHE_DIR=cache_dir)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["from_cache"] is True and out["probes"] == 0
    assert out["choices"] == expect
    assert out["read_through"] == expect


def test_key_covers_spec_and_hardware():
    spec = matmul_spec()
    key = cache_key(spec, H100, {"seed": 0})
    changed = [
        dataclasses.replace(spec, regs_per_thread=200),
        dataclasses.replace(spec, compute_unit="f32"),
        dataclasses.replace(spec, source_fingerprint="abc"),
        dataclasses.replace(spec, threads=spec.threads * 2),
        dataclasses.replace(spec, constraints=spec.constraints[:-1]),
    ]
    keys = {cache_key(s, H100, {"seed": 0}) for s in changed}
    assert key not in keys and len(keys) == len(changed)
    assert cache_key(spec, dataclasses.replace(H100, sm_count=114),
                     {"seed": 0}) != key
    assert cache_key(spec, H100, {"seed": 1}) != key
    fp = spec_fingerprint(spec)
    assert {"threads", "regs_per_thread", "compute_unit",
            "source_fingerprint"} <= set(fp)
    json.dumps(fp)


def test_oracle_fingerprint_is_part_of_the_key(cache_dir):
    _build(HopperModel(noise=0.03, seed=5))
    assert not _build(HopperModel(noise=0.03, seed=6)).from_cache
    assert not _build(HopperModel(noise=0.05, seed=5)).from_cache
    assert _build(HopperModel(noise=0.03, seed=5)).from_cache


def test_timer_fingerprint_folds_in_the_kernel_sources(monkeypatch):
    """An edited ``.cu`` (here a patched ``source_bytes``) changes
    ``CudaEventTimer``'s fingerprint, so a driver tuned on the old kernel
    is never found."""
    timer = object.__new__(dm.CudaEventTimer)
    timer.hw, timer.warmup, timer.timings, timer.seed = H100, 1, 3, 0
    before = timer.fingerprint()
    assert before["sources"] == dm.kernel_sources_digest()
    real = kernel_build.source_bytes
    monkeypatch.setattr(kernel_build, "source_bytes",
                        lambda name, csrc=None: real(name, csrc) + (
                            b"// edited" if name == "matmul" else b""))
    after = timer.fingerprint()
    assert after["sources"] != before["sources"]
    spec = matmul_spec()
    assert cache_key(spec, H100, {"oracle": before}) != \
        cache_key(spec, H100, {"oracle": after})


def test_tampered_entry_is_evicted(cache_dir):
    first = _build()
    cache = default_cache()
    (entry,) = [cache.lookup_latest("matmul_b16")]
    path = cache.path("matmul_b16", entry.key)
    with open(path) as f:
        raw = json.load(f)
    raw["source"] += "\n# edited\n"
    with open(path, "w") as f:
        json.dump(raw, f)
    assert cache.get("matmul_b16", entry.key) is None
    assert not os.path.exists(path)
    rebuilt = _build()
    assert not rebuilt.from_cache
    assert rebuilt.driver.source == first.driver.source


def test_generations_and_invalidate(cache_dir):
    cache = default_cache()
    _build(cache_version=0)
    newer = _build(cache_version=2, use_cache=False, seed=9)
    assert newer.driver.tuning_version == 2
    assert cache.lookup_latest("matmul_b16").tuning_version == 2
    assert cache.kernels() == ["matmul_b16"]
    assert cache.invalidate("matmul_b16", below_version=2) == 1
    assert cache.lookup_latest("matmul_b16").tuning_version == 2
    assert cache.invalidate("matmul_b16", hw_name="other_card") == 0
    assert cache.invalidate("matmul_b16") == 1
    assert cache.lookup_latest("matmul_b16") is None
    _build()
    cache.clear()
    assert cache.kernels() == []


def test_choose_or_default_reads_through(cache_dir):
    default = {"bm": -1, "bn": -1, "bk": -1}
    D = {"m": 4096, "n": 4096, "k": 4096}
    spec = matmul_spec()
    assert choose_or_default("matmul_b16", D, default, spec=spec) == default
    assert registry.known_cache_miss("matmul_b16", H100.name)
    first = _build()                    # not registered
    # the miss is remembered until the registry changes
    assert choose_or_default("matmul_b16", D, default, spec=spec) == default
    registry.clear()
    # without the spec only the registry is read
    assert choose_or_default("matmul_b16", D, default) == default
    assert choose_or_default("matmul_b16", D, default, spec=spec) == \
        first.driver.choose(D)
    assert registry.get("matmul_b16").source == first.driver.source
    # entries tuned for another card are not read
    registry.clear()
    other = dataclasses.replace(H100, name="other_card")
    assert get_driver("matmul_b16", spec, hw=other) is None
    with pytest.raises(ValueError):
        get_driver("matmul_b32", spec)
    registry.clear()
    assert warm_start_from_cache([spec]) == ["matmul_b16"]
    assert warm_start_from_cache([spec]) == []      # already registered
    registry.clear()
    assert warm_start_from_cache([spec, matmul_spec(4)], hw=other) == []


@pytest.mark.parametrize("edit", ["source", "spec"])
def test_read_through_ignores_drivers_of_other_code(cache_dir, monkeypatch,
                                                    edit):
    """A driver built before the kernel's ``.cu`` (here a patched
    ``source_bytes``) or its spec changed is never served by the
    read-through: ``choose_or_default`` falls back to the default, and
    ``warm_start_from_cache`` loads nothing."""
    default = {"bm": -1, "bn": -1, "bk": -1}
    D = {"m": 4096, "n": 4096, "k": 4096}
    spec = matmul_spec()
    built = _build()
    assert choose_or_default("matmul_b16", D, default, spec=spec) == \
        built.driver.choose(D)
    registry.clear()
    before = code_digest(spec)
    if edit == "source":
        real = kernel_build.source_bytes
        monkeypatch.setattr(kernel_build, "source_bytes",
                            lambda name, csrc=None: real(name, csrc) + (
                                b"// edited" if name == "matmul" else b""))
    else:
        spec = dataclasses.replace(spec, regs_per_thread=200)
    assert code_digest(spec) != before
    assert default_cache().lookup_latest("matmul_b16") is not None
    assert choose_or_default("matmul_b16", D, default, spec=spec) == default
    assert registry.get("matmul_b16") is None
    registry.clear()
    assert warm_start_from_cache([spec]) == []
    # and the build key misses too: the edited code is tuned anew
    assert not _build(spec=spec).from_cache


def test_bad_entry_is_skipped_with_one_warning(cache_dir, monkeypatch,
                                               caplog):
    import repro_torch.core.driver as driver_mod

    monkeypatch.setattr(driver_mod, "_bad_entry_warned", False)
    spec = matmul_spec()
    DriverCache().put(CacheEntry(
        kernel="matmul_b16", key="0" * 64, source="def broken(:\n",
        fits={}, code=code_digest(spec), created_at=1.0, hw_name=H100.name))
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.driver"):
        assert warm_start_from_cache([spec]) == []
        assert choose_or_default("matmul_b16", {"m": 64, "n": 64, "k": 64},
                                 {"bm": -1}, spec=spec) == {"bm": -1}
    assert sum("failed to load" in r.message for r in caplog.records) == 1


def test_port_and_reference_entries_never_meet(cache_dir):
    """Both packages share the root and the kernel name ``matmul_b16``; the
    port's entries live under ``repro_torch/`` and neither package reads
    the other's."""
    prev = ref_registry.get("matmul_b16")
    try:
        _build()
        assert ref_default_cache().lookup_latest("matmul_b16") is None
        RefKlaraptor(V5eSimulator(seed=1)).build_driver(
            ref_matmul_spec(), repeats=1, max_configs_per_size=8,
            register=False)
        assert ref_default_cache().lookup_latest("matmul_b16") is not None
        port = default_cache()
        assert port.root == os.path.join(cache_dir, "repro_torch")
        assert port.kernels() == ["matmul_b16"]
        (entry,) = port._entries("matmul_b16")
        assert entry.hw_name == H100.name
        port.clear()
        assert port.lookup_latest("matmul_b16") is None
        assert ref_default_cache().lookup_latest("matmul_b16") is not None
    finally:
        if prev is None:
            ref_registry.invalidate_kernel("matmul_b16")
        else:
            ref_registry.register(prev)


def test_unwritable_directory_warns_once(tmp_path, monkeypatch, caplog):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(blocker / "sub"))
    monkeypatch.setattr(tuner_mod.Klaraptor, "_cache_write_warned", False)
    registry.clear()
    try:
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.core.tuner"):
            a = _build()
            b = _build(seed=3)
    finally:
        registry.clear()
    assert not a.from_cache and not b.from_cache
    assert a.collected.n_probe_executions > 0
    assert sum("cache write failed" in r.message
               for r in caplog.records) == 1


def test_cache_false_and_explicit_store(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "default"))
    Klaraptor(HopperModel(seed=1), device="cpu", cache=False).build_driver(
        matmul_spec(), register=False, **BUILD)
    assert not (tmp_path / "default").exists()
    store = DriverCache(str(tmp_path / "mine"))
    kl = Klaraptor(HopperModel(seed=1), device="cpu", cache=store)
    kl.build_driver(matmul_spec(), register=False, **BUILD)
    assert kl.build_driver(matmul_spec(), register=False, **BUILD).from_cache
    assert store.kernels() == ["matmul_b16"]
    assert not (tmp_path / "default").exists()
