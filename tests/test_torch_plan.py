"""The port's compiled launch plans: ``choose_many``, the
``LaunchPlanTable``, plans in the driver cache and in a fresh process's
warm start, the dispatch order memo > override > plan > driver > default,
``RationalProgram.specialize`` and the ``fit_tile`` memo.

The classes mirror ``tests/test_plan.py``'s of the same names, with drivers
built on ``HopperModel`` (the analytic H100) on the CPU.  ``TestParity``
holds the hardware-free parts against the JAX package on the same inputs,
exactly (integers, keys, JSON and fitted evaluations alike, the tolerance
of ``test_torch_core.py::test_rational_function_evaluations_equal``).
``TestPlanCode`` holds the port's own rule: a plan serves only the kernel
code and the driver it was compiled from.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from repro.core import V5eSimulator
from repro.core import Klaraptor as RefKlaraptor
from repro.core import compile_plan as ref_compile_plan
from repro.core import matmul_spec as ref_matmul_spec
from repro.core import rational_program as ref_rp
from repro.core.collect import collect as ref_collect
from repro.core.fitting import fit_auto as ref_fit_auto
from repro.core.plan import LaunchPlanTable as RefLaunchPlanTable
from repro.core.plan import _mix64 as ref_mix64
from repro.core.plan import pack_shape as ref_pack_shape
from repro.core.plan import plan_key as ref_plan_key

from repro_torch.core import (H100, CacheEntry, DriverCache, DriverProgram,
                              HopperModel, Klaraptor, PlanEntry,
                              choose_or_default, code_digest, compile_plan,
                              flash_attention_spec,
                              flash_probe_data, gmm_probe_data, lattice,
                              matmul_spec, moe_gmm_spec, precompile_plans,
                              register_driver, registry, set_choice_listener,
                              ssd_probe_data, ssd_scan_spec,
                              warm_start_from_cache)
from repro_torch.core import rational_program as port_rp
from repro_torch.core.collect import from_reference_collected
from repro_torch.core.fitting import fit_auto
from repro_torch.core.plan import (LaunchPlanTable, _mix64, pack_shape,
                                   plan_key)

SPECS = {
    "matmul": (matmul_spec, None),
    "flash": (flash_attention_spec, flash_probe_data),
    "moe": (moe_gmm_spec, gmm_probe_data),
    "ssd": (ssd_scan_spec, ssd_probe_data),
}

ENVELOPES = {
    "matmul": {"m": [512, 1024, 2048, 4096], "n": [512, 1024, 2048, 4096],
               "k": [512, 1024]},
    "flash": {"bh": [2, 8], "sq": [512, 1024, 2048, 4096],
              "skv": [1024, 2048]},
    "moe": {"e": [2, 8], "g": [256, 1024], "k": [512, 1024],
            "n": [512, 1024]},
    "ssd": {"bh": [2, 8], "s": [1024, 2048, 4096], "chunkflops": [1]},
}
# A matmul_b16 shape outside the lattice that the bf16 kernel takes
# (every extent a multiple of 64).
OFF_LATTICE = {"m": 192, "n": 384, "k": 640}
IN_LATTICE = {"m": 1024, "n": 2048, "k": 512}


def _build(spec, probe=None, oracle=None, **kw):
    kl = Klaraptor(oracle or HopperModel(noise=0.03, seed=7), device="cpu",
                   cache=kw.pop("cache", False))
    if probe is not None:
        kw.setdefault("probe_data", probe())
    return kl.build_driver(spec, repeats=2, max_configs_per_size=16, **kw)


@pytest.fixture(scope="module")
def builds():
    """One driver per hand-specced kernel, built once (not registered)."""
    return {name: _build(make(), probe, register=False)
            for name, (make, probe) in SPECS.items()}


@pytest.fixture()
def clean(tmp_path, monkeypatch):
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "cache"))
    registry.clear()
    set_choice_listener(None)
    yield
    registry.clear()
    set_choice_listener(None)


def _rows(driver, cols):
    n = next(iter(cols.values())).shape[0]
    return [{d: int(cols[d][i]) for d in driver.data_params}
            for i in range(n)]


# choose() as the generator wrote it before choose_many existed (the driver
# modules of the earlier ports' caches): the feasible candidates sorted by
# lexsort -- near-optimal first, then most blocks per SM, then fewest grid
# steps, then the candidate index.
_LEGACY_CHOOSE = """


def choose({d_sig}, margin=0.02):
    key = ({d_sig},)
    hit = _HISTORY.get(key)
    if hit is not None:
        return dict(zip(PROGRAM_PARAMS, hit))
    cols = candidates({d_sig})
    if cols[PROGRAM_PARAMS[0]].size == 0:
        raise ValueError("no feasible launch configuration")
    args = dict(zip(DATA_PARAMS, ({d_sig},)), **cols)
    est = np.asarray(estimate(**args), dtype=np.float64)
    near = est <= float(np.min(est)) * (1.0 + margin)
    blocks = np.broadcast_to(blocks_per_sm(**args), est.shape)
    steps = np.broadcast_to(grid_steps(**args), est.shape)
    order = np.lexsort((np.asarray(steps, dtype=np.float64),
                        -np.asarray(blocks, dtype=np.float64), ~near))
    pick = int(order[0])
    cfg = tuple(int(cols[p][pick]) for p in PROGRAM_PARAMS)
    _HISTORY[key] = cfg
    return dict(zip(PROGRAM_PARAMS, cfg))
"""


def _legacy_source(driver):
    """``driver``'s module without ``choose_many``, its ``choose`` the
    lexsort one above."""
    cut = driver.source.index("\n\ndef choose_many")
    return driver.source[:cut] + _LEGACY_CHOOSE.format(
        d_sig=", ".join(driver.data_params))


# ---------------------------------------------------------------------------
# choose_many: the batched selection agrees exactly with choose()
# ---------------------------------------------------------------------------

class TestChooseMany:
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_agrees_with_choose(self, builds, name):
        driver = builds[name].driver
        cols = lattice(ENVELOPES[name])
        cfgs, ok = driver.choose_many(cols)
        for i, D in enumerate(_rows(driver, cols)):
            driver.namespace["_HISTORY"].clear()
            ref = driver.choose(D)
            assert bool(ok[i]), (name, D)
            assert ref == {p: int(cfgs[p][i])
                           for p in driver.program_params}, (name, D)

    @pytest.mark.parametrize("margin", [0.0, 0.1])
    def test_margin_tiebreak_agrees(self, builds, margin):
        # A wide margin puts many rows in the blocks-per-SM / grid-steps
        # tie-break: the agreement must hold there too.
        driver = builds["matmul"].driver
        cols = lattice(ENVELOPES["matmul"])
        cfgs, ok = driver.choose_many(cols, margin=margin)
        for i, D in enumerate(_rows(driver, cols)):
            driver.namespace["_HISTORY"].clear()
            assert driver.choose(D, margin=margin) == {
                p: int(cfgs[p][i]) for p in driver.program_params}

    @pytest.mark.parametrize("margin", [0.02, 0.0, 0.1])
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_agrees_with_lexsort_choose(self, builds, name, margin):
        """The masked reductions pick what a lexsort of the feasible
        candidates picks, shape by shape (``choose`` is ``choose_many`` on
        one row, so this is the check of the selection order itself)."""
        driver = builds[name].driver
        legacy = DriverProgram.from_source(driver.kernel,
                                           _legacy_source(driver), driver.hw)
        cols = lattice(ENVELOPES[name])
        cfgs, ok = driver.choose_many(cols, margin=margin)
        assert ok.all(), name
        for i, D in enumerate(_rows(driver, cols)):
            assert legacy.choose(D, margin=margin) == {
                p: int(cfgs[p][i]) for p in driver.program_params}, (name, D)

    def test_infeasible_shapes_flagged(self, builds):
        driver = builds["matmul"].driver
        # k = 1: every bk candidate (>= 64) exceeds the extent.
        cols = {"m": np.array([1024, 1024]), "n": np.array([1024, 1024]),
                "k": np.array([1024, 1])}
        cfgs, ok = driver.choose_many(cols)
        assert list(ok) == [True, False]
        assert all(int(cfgs[p][1]) == 0 for p in driver.program_params)
        with pytest.raises(ValueError):
            driver.choose({"m": 1024, "n": 1024, "k": 1})

    def test_fills_decision_history(self, builds):
        driver = builds["matmul"].driver
        driver.namespace["_HISTORY"].clear()
        cols = lattice(ENVELOPES["matmul"])
        cfgs, ok = driver.choose_many(cols)
        assert len(driver.namespace["_HISTORY"]) == int(ok.sum())
        # choose() now answers from the history: break estimate() to show
        # that nothing is evaluated again.
        driver.namespace["estimate"] = None
        try:
            D = _rows(driver, cols)[0]
            assert driver.choose(D) == {p: int(cfgs[p][0])
                                        for p in driver.program_params}
        finally:
            del driver.namespace["estimate"]
            exec(compile(driver.source, "<d>", "exec"), driver.namespace)

    def test_legacy_driver_fallback(self, builds):
        """A driver module without choose_many is asked row by row, with
        identical results."""
        modern = builds["flash"].driver
        legacy = DriverProgram.from_source(modern.kernel,
                                           _legacy_source(modern), modern.hw)
        assert "choose_many" not in legacy.namespace
        cols = lattice(ENVELOPES["flash"])
        got, ok_l = legacy.choose_many(cols)
        want, ok_m = modern.choose_many(cols)
        assert list(ok_l) == list(ok_m)
        for p in modern.program_params:
            assert list(got[p]) == list(want[p])

    def test_scalar_broadcast(self, builds):
        driver = builds["ssd"].driver
        cfgs, ok = driver.choose_many(
            {"bh": 8, "s": np.array([1024, 2048, 4096]), "chunkflops": 1})
        assert ok.shape == (3,) and ok.all()


# ---------------------------------------------------------------------------
# LaunchPlanTable: packed keys, open addressing, persistence
# ---------------------------------------------------------------------------

class TestLaunchPlanTable:
    def _table(self, n=64, tuning_version=3):
        rng = np.random.RandomState(0)
        shapes = {"a": rng.randint(1, 1 << 40, n),
                  "b": rng.randint(1, 1 << 20, n)}
        configs = {"x": rng.randint(8, 1024, n),
                   "y": rng.randint(8, 1024, n)}
        table = LaunchPlanTable.build(
            "k", H100.name, ("a", "b"), ("x", "y"), shapes, configs,
            tuning_version=tuning_version, source_hash="abc123")
        return table, shapes, configs

    def test_lookup_hit_and_miss(self):
        table, shapes, configs = self._table()
        for i in range(len(shapes["a"])):
            D = {"a": int(shapes["a"][i]), "b": int(shapes["b"][i])}
            assert table.lookup(D) == {"x": int(configs["x"][i]),
                                       "y": int(configs["y"][i])}
        assert table.lookup({"a": 123456789, "b": 42}) is None
        assert table.lookup({"a": 1}) is None          # a data param missing

    def test_load_factor_and_entry_count(self):
        table, *_ = self._table(n=100)
        assert len(table) == 100
        assert table.hashes.shape[0] >= 200        # load factor <= 0.5
        assert len(table.entries()) == 100

    def test_duplicate_shape_last_wins(self):
        table = LaunchPlanTable.build(
            "k", H100.name, ("a",), ("x",),
            {"a": np.array([7, 7])}, {"x": np.array([8, 512])})
        assert len(table) == 1
        assert table.lookup({"a": 7}) == {"x": 512}

    def test_ok_mask_drops_rows(self):
        table = LaunchPlanTable.build(
            "k", H100.name, ("a",), ("x",),
            {"a": np.array([1, 2, 3])}, {"x": np.array([10, 20, 30])},
            ok=np.array([True, False, True]))
        assert len(table) == 2
        assert table.lookup({"a": 2}) is None

    def test_json_roundtrip(self):
        table, shapes, configs = self._table()
        clone = LaunchPlanTable.from_json(
            json.loads(json.dumps(table.to_json())))
        assert clone.tuning_version == table.tuning_version
        assert clone.source_hash == "abc123"
        assert clone.data_params == table.data_params
        assert len(clone) == len(table)
        for i in range(len(shapes["a"])):
            D = {"a": int(shapes["a"][i]), "b": int(shapes["b"][i])}
            assert clone.lookup(D) == table.lookup(D)

    def test_pack_shape_stable_and_positive(self):
        assert pack_shape((4096, 4096, 512)) == pack_shape((4096, 4096, 512))
        assert pack_shape((4096, 4096, 512)) != pack_shape((4096, 512, 4096))
        for v in [(0,), (1 << 62, 1 << 62), (2**40, 3, 5)]:
            assert 0 <= pack_shape(v) < 2 ** 63


# ---------------------------------------------------------------------------
# Dispatch: choose_or_default consults the plan before the driver
# ---------------------------------------------------------------------------

class TestDispatch:
    def _install(self, builds, name="matmul", register=True):
        driver = builds[name].driver
        if register:
            register_driver(driver)
        plan = compile_plan(driver, lattice(ENVELOPES[name]))
        registry.register_plan(plan)
        return driver, plan

    def test_plan_source_and_config(self, clean, builds):
        driver, plan = self._install(builds)
        events = []
        set_choice_listener(events.append)
        cfg = choose_or_default(driver.kernel, IN_LATTICE, {"bm": -1})
        assert events[-1].source == "plan"
        driver.namespace["_HISTORY"].clear()
        assert cfg == driver.choose(IN_LATTICE)
        assert registry.stats()["plan_hits"] == 1

    def test_plan_serves_without_driver(self, clean, builds):
        """A plan alone, with no driver anywhere, decides."""
        driver, plan = self._install(builds, register=False)
        assert registry.get(driver.kernel) is None
        cfg = choose_or_default(driver.kernel, IN_LATTICE, {"bm": -1})
        assert cfg == plan.lookup(IN_LATTICE)
        assert cfg != {"bm": -1}

    def test_lazy_fill_outside_envelope(self, clean, builds):
        # The memo would answer the repeat before the plan does; this test
        # is about the registry's fill path behind it.
        from repro_torch.core import set_decision_memo
        prev = set_decision_memo(False)
        try:
            driver, _ = self._install(builds)
            events = []
            set_choice_listener(events.append)
            first = choose_or_default(driver.kernel, OFF_LATTICE, {"bm": -1})
            second = choose_or_default(driver.kernel, OFF_LATTICE,
                                       {"bm": -1})
            assert [e.source for e in events] == ["driver", "plan"]
            assert first == second
            stats = registry.stats()
            assert stats["plan_misses"] == 1 and stats["plan_hits"] == 1
        finally:
            set_decision_memo(prev)

    def test_override_outranks_plan(self, clean, builds):
        driver, _ = self._install(builds)
        pinned = {"bm": 64, "bn": 64, "bk": 64}
        registry.note_override(driver.kernel, driver.hw.name, IN_LATTICE,
                               pinned)
        assert choose_or_default(driver.kernel, IN_LATTICE,
                                 {"bm": -1}) == pinned

    def test_invalidate_kernel_drops_plan_and_fills(self, clean, builds):
        driver, _ = self._install(builds)
        choose_or_default(driver.kernel, OFF_LATTICE, {"bm": -1})  # a fill
        registry.invalidate_kernel(driver.kernel)
        assert registry.plan(driver.kernel, driver.hw.name) is None
        assert choose_or_default(driver.kernel, OFF_LATTICE,
                                 {"bm": -1}) == {"bm": -1}

    def test_new_driver_generation_drops_plan(self, clean, builds):
        """Another driver retires the plan (frozen output of the old one);
        the same module registered again keeps it."""
        driver, plan = self._install(builds)
        register_driver(driver)
        assert registry.plan(driver.kernel, driver.hw.name) is plan
        other = DriverProgram.from_source(
            driver.kernel, driver.source + "\n# refit\n", driver.hw,
            tuning_version=1)
        register_driver(other)
        assert registry.plan(driver.kernel, driver.hw.name) is None

    def test_stale_fill_rejected_after_hot_swap(self, clean, builds):
        """A config decided by another driver than the plan's is not pinned
        into the plan."""
        driver, _ = self._install(builds)
        old_cfg = {"bm": 64, "bn": 128, "bk": 128}
        registry.note_plan_fill(driver.kernel, driver.hw.name, OFF_LATTICE,
                                old_cfg, source_hash="stale-generation")
        assert registry.plan_lookup(driver.kernel, driver.hw.name,
                                    OFF_LATTICE) is None
        registry.note_plan_fill(driver.kernel, driver.hw.name, OFF_LATTICE,
                                old_cfg, source_hash=driver.source_hash)
        assert registry.plan_lookup(driver.kernel, driver.hw.name,
                                    OFF_LATTICE) == old_cfg

    def test_choose_many_counters(self, clean, builds):
        driver = builds["ssd"].driver
        driver.choose_many(lattice(ENVELOPES["ssd"]))
        stats = registry.stats()
        assert stats["choose_many_calls"] == 1
        assert stats["choose_many_rows"] == 6


# ---------------------------------------------------------------------------
# Plans in the driver cache, and a fresh process's warm start
# ---------------------------------------------------------------------------

def _plan_entry(version=0, key="p" * 64, code=""):
    table = LaunchPlanTable.build(
        "k", H100.name, ("a",), ("x",),
        {"a": np.array([64, 128])}, {"x": np.array([8, 16])},
        tuning_version=version, code=code)
    return PlanEntry(kernel="k", key=key, hw_name=H100.name,
                     plan=table.to_json(), created_at=1.0,
                     tuning_version=version)


class TestPlanCache:
    def test_put_get_roundtrip(self, clean):
        cache = DriverCache()
        cache.put_plan(_plan_entry())
        entry = cache.get_plan("k", "p" * 64)
        assert entry is not None
        assert LaunchPlanTable.from_json(entry.plan).lookup(
            {"a": 128}) == {"x": 16}

    def test_lookup_latest_prefers_generation(self, clean):
        cache = DriverCache()
        cache.put_plan(_plan_entry(version=0, key="a" * 64))
        cache.put_plan(_plan_entry(version=2, key="b" * 64))
        assert cache.lookup_latest_plan("k", H100.name).tuning_version == 2

    def test_tampered_plan_evicted(self, clean):
        cache = DriverCache()
        path = cache.put_plan(_plan_entry())
        with open(path) as f:
            raw = json.load(f)
        raw["tuning_version"] = 99
        with open(path, "w") as f:
            json.dump(raw, f)
        assert cache.get_plan("k", "p" * 64) is None
        assert not os.path.exists(path)

    def test_invalidate_below_version_evicts_plans(self, clean):
        cache = DriverCache()
        for v, key in ((0, "a" * 64), (1, "b" * 64)):
            cache.put_plan(_plan_entry(version=v, key=key))
        removed = cache.invalidate("k", H100.name, below_version=1)
        assert removed == 1
        assert cache.get_plan("k", "a" * 64) is None
        assert cache.get_plan("k", "b" * 64) is not None

    def test_plan_files_invisible_to_driver_lookup(self, clean):
        cache = DriverCache()
        cache.put_plan(_plan_entry())
        assert cache.lookup_latest("k", H100.name) is None


def _build_cached():
    """A matmul_b16 driver, registered and written to the default cache."""
    return _build(matmul_spec(), oracle=HopperModel(noise=0.03, seed=5),
                  cache=None, register=True)


class TestFleetWarmStart:
    def test_precompile_then_fleet_load(self, clean):
        build = _build_cached()
        kernel, axes = build.driver.kernel, ENVELOPES["matmul"]
        first = precompile_plans({kernel: axes})
        assert first["compiled"] == [kernel]
        assert first["entries"] == len(registry.plan(kernel, H100.name))

        # "Another process": an empty registry, everything from the cache.
        registry.clear()
        summary = warm_start_from_cache([matmul_spec()])
        assert summary == [kernel]
        assert summary.plans_loaded == [kernel]
        second = precompile_plans({kernel: axes})
        assert second["loaded"] == [kernel]             # not compiled again
        events = []
        set_choice_listener(events.append)
        choose_or_default(kernel, IN_LATTICE, {"bm": -1})
        assert events[-1].source == "plan"

    def test_lazy_read_through_installs_plan(self, clean):
        """A process that never warm-starts still gets the plan: the
        read-through of choose_or_default (given the spec) installs the
        cached plan compiled from the driver it loads."""
        build = _build_cached()
        precompile_plans({build.driver.kernel: ENVELOPES["matmul"]})
        registry.clear()
        events = []
        set_choice_listener(events.append)
        cfg = choose_or_default(build.driver.kernel, IN_LATTICE, {"bm": -1},
                                spec=matmul_spec())
        assert events[-1].source == "plan"
        assert cfg != {"bm": -1}

    def test_precompile_skips_untuned_kernel(self, clean):
        summary = precompile_plans({"nonexistent_kernel": {"m": [8]}})
        assert summary["skipped"] == ["nonexistent_kernel"]
        assert summary["entries"] == 0

    def test_precompile_survives_unwritable_cache(self, clean, builds,
                                                  tmp_path, monkeypatch,
                                                  caplog):
        """A node whose cache cannot be written still compiles and serves
        its plans; the write warns once."""
        import repro_torch.core.plan as plan_mod
        blocker = tmp_path / "blocker"
        blocker.write_text("")
        monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(blocker / "sub"))
        monkeypatch.setattr(plan_mod, "_plan_write_warned", False)
        register_driver(builds["matmul"].driver)
        with caplog.at_level(logging.WARNING,
                             logger="repro_torch.core.plan"):
            summary = precompile_plans({"matmul_b16": ENVELOPES["matmul"]})
        assert summary["compiled"] == ["matmul_b16"]
        assert registry.plan("matmul_b16", H100.name) is not None
        assert any("plan artifact write failed" in r.message
                   for r in caplog.records)

    def test_warm_start_summary_counts(self, clean):
        summary = warm_start_from_cache([matmul_spec()])
        assert summary == [] and summary.plans_loaded == []
        assert summary.skipped_no_entry == 1
        build = _build_cached()                    # registered and cached
        summary = warm_start_from_cache([matmul_spec()])
        assert summary == [] and summary.already_registered == 1
        registry.clear()
        summary = warm_start_from_cache([matmul_spec(), matmul_spec(4)])
        assert list(summary) == [build.driver.kernel]
        assert summary.skipped_no_entry == 1          # matmul_b32: none
        assert set(summary.as_dict()) == {
            "loaded", "plans_loaded", "already_registered",
            "skipped_no_entry", "skipped_bad"}

    def test_stale_plan_not_loaded_for_new_driver(self, clean):
        """A cached plan of another driver is not installed beside the
        driver that serves."""
        build = _build_cached()
        plan = compile_plan(build.driver, lattice(ENVELOPES["matmul"]))
        stale = LaunchPlanTable.from_json(
            {**plan.to_json(), "source_hash": "deadbeef"})
        DriverCache().put_plan(PlanEntry(
            kernel=build.driver.kernel, key="s" * 64, hw_name=H100.name,
            plan=stale.to_json(), created_at=1.0))
        registry.clear()
        summary = warm_start_from_cache([matmul_spec()])
        assert summary == [build.driver.kernel]
        assert summary.plans_loaded == []


# ---------------------------------------------------------------------------
# The port's rule: a plan serves only its kernel code and its driver
# ---------------------------------------------------------------------------

def _recode(entry: PlanEntry, code: str) -> PlanEntry:
    """The same plan, claiming another code digest, under a valid content
    hash (so the code check refuses it, not the tamper check)."""
    return dataclasses.replace(entry, plan={**entry.plan, "code": code})


class TestPlanCode:
    def test_compiled_plan_carries_driver_and_code(self, clean):
        build = _build_cached()
        assert build.driver.code == code_digest(matmul_spec())
        precompile_plans({build.driver.kernel: ENVELOPES["matmul"]})
        (entry,) = DriverCache()._plan_entries(build.driver.kernel)
        assert entry.code == build.driver.code
        assert entry.plan["source_hash"] == build.driver.source_hash
        # the key folds in both: the same envelope under other code is
        # another artifact
        axes = ENVELOPES["matmul"]
        assert entry.key == plan_key(
            build.driver.kernel, H100.name, axes, 0,
            build.driver.source_hash, build.driver.code)
        assert entry.key != plan_key(build.driver.kernel, H100.name, axes,
                                     0, build.driver.source_hash, "other")

    @pytest.mark.parametrize("with_driver", [True, False])
    def test_plan_of_other_code_is_not_installed(self, clean, with_driver):
        build = _build_cached()
        kernel = build.driver.kernel
        precompile_plans({kernel: ENVELOPES["matmul"]})
        cache = DriverCache()
        if not with_driver:
            for e in cache._entries(kernel):
                os.remove(cache.path(kernel, e.key))
        registry.clear()
        summary = warm_start_from_cache([matmul_spec()])
        assert list(summary) == ([kernel] if with_driver else [])
        assert summary.plans_loaded == [kernel]     # its own code: served
        # the plan claims other code
        (entry,) = cache._plan_entries(kernel)
        cache.put_plan(_recode(entry, "0" * 64))
        registry.clear()
        summary = warm_start_from_cache([matmul_spec()])
        assert summary.plans_loaded == []
        assert registry.plan(kernel, H100.name) is None
        # ... and through the read-through of choose_or_default
        registry.clear()
        events = []
        set_choice_listener(events.append)
        choose_or_default(kernel, IN_LATTICE, {"bm": -1}, spec=matmul_spec())
        assert events[-1].source == ("driver" if with_driver else "default")

    def test_edited_spec_finds_no_plan(self, clean):
        """With no driver, a plan is installed only under the code the
        caller's spec names now: an edited spec finds none."""
        build = _build_cached()
        kernel = build.driver.kernel
        precompile_plans({kernel: ENVELOPES["matmul"]})
        cache = DriverCache()
        for e in cache._entries(kernel):
            os.remove(cache.path(kernel, e.key))
        edited = dataclasses.replace(matmul_spec(), regs_per_thread=200)
        assert code_digest(edited) != code_digest(matmul_spec())
        registry.clear()
        assert warm_start_from_cache([edited]).plans_loaded == []
        registry.clear()
        assert warm_start_from_cache([matmul_spec()]).plans_loaded == \
            [kernel]

    def test_hw_defaults_to_the_serving_driver(self, clean, builds,
                                               monkeypatch):
        """On a host whose card is named otherwise than the table a driver
        was built on (a ``HopperModel`` build on a card host), plans,
        overrides, memo entries and step plans are keyed on the driver's
        hardware, where the JAX package defaults to its TPU table: every
        path below finds what was stored for it."""
        import repro_torch.core.driver as driver_mod
        from repro_torch.core import build_step_plan
        from repro_torch.core.step_plan import KernelRequest

        card = dataclasses.replace(H100, name="NVIDIA H100 80GB HBM3")
        monkeypatch.setattr(driver_mod, "local_hw", lambda: card)
        drv = builds["matmul"].driver
        assert drv.hw.name == H100.name != card.name
        register_driver(drv)
        summary = precompile_plans({"matmul_b16": ENVELOPES["matmul"]})
        assert summary["compiled"] == ["matmul_b16"]
        (entry,) = DriverCache()._plan_entries("matmul_b16")
        assert entry.hw_name == entry.plan["hw_name"] == H100.name
        assert registry.plan("matmul_b16", card.name) is None
        events = []
        set_choice_listener(events.append)
        choose_or_default("matmul_b16", IN_LATTICE, {"bm": -1})
        assert (events[-1].source, events[-1].hw_name) == ("plan", H100.name)
        pinned = {"bm": 128, "bn": 128, "bk": 64}
        registry.note_override("matmul_b16", H100.name, OFF_LATTICE, pinned)
        assert choose_or_default("matmul_b16", OFF_LATTICE,
                                 {"bm": -1}) == pinned
        assert events[-1].source == "override"
        choose_or_default("matmul_b16", OFF_LATTICE, {"bm": -1})
        assert events[-1].source == "override"         # the memo's entry
        sp = build_step_plan([KernelRequest.make("matmul_b16", D, {"bm": -1})
                              for D in (IN_LATTICE, OFF_LATTICE)])
        assert sp.describe()["sources"] == {"plan": 1, "override": 1}
        # naming the card reads the card's, which hold nothing
        choose_or_default("matmul_b16", IN_LATTICE, {"bm": -1}, hw=card)
        assert (events[-1].source, events[-1].hw_name) == ("driver",
                                                           card.name)
        # a plan registered without its driver serves under its own name
        plan = registry.plan("matmul_b16", H100.name)
        registry.clear()
        registry.register_plan(plan)
        assert registry.hw_name("matmul_b16") == H100.name
        choose_or_default("matmul_b16", IN_LATTICE, {"bm": -1})
        assert events[-1].source == "plan"
        registry.clear()
        assert registry.hw_name("matmul_b16") == card.name
        # a registered driver warm-starts the plans of its own hardware
        register_driver(drv)
        assert warm_start_from_cache([matmul_spec()]).plans_loaded == [
            "matmul_b16"]
        assert registry.plan("matmul_b16", H100.name) is not None

    def test_compile_plan_takes_the_named_hw(self, clean, builds):
        """``precompile_plans(hw=...)`` stamps the table and its cache entry
        with the same hardware name."""
        other = dataclasses.replace(H100, name="other-card")
        register_driver(builds["matmul"].driver)
        precompile_plans({"matmul_b16": ENVELOPES["matmul"]}, hw=other)
        (entry,) = DriverCache()._plan_entries("matmul_b16")
        assert entry.hw_name == entry.plan["hw_name"] == "other-card"
        assert registry.plan("matmul_b16", "other-card") is not None
        assert registry.plan("matmul_b16", H100.name) is None

    def test_default_plan_envelope_pads_the_matmul_m(self):
        """The serving envelope is the JAX package's, with the matmul's m
        rounded up to the bf16 granule as ``ops.matmul`` pads it."""
        from repro.launch.serve import default_plan_envelope as ref_env

        from repro_torch.launch.serve import default_plan_envelope
        for batch, max_seq in ((1, 128), (4, 1024), (96, 4096)):
            mine, theirs = default_plan_envelope(batch, max_seq), \
                ref_env(batch, max_seq)
            assert mine.keys() == theirs.keys()
            for kernel in theirs:
                if kernel != "matmul_b16":
                    assert mine[kernel] == theirs[kernel]
            m = theirs["matmul_b16"]
            assert mine["matmul_b16"] == {
                **m, "m": sorted({-(-v // 64) * 64 for v in m["m"]})}

    def test_cached_driver_without_choose_many(self, clean, builds):
        """A cached driver module written before ``choose_many`` existed
        (as the drivers of earlier ports were) loads, and its choose_many
        falls back to choose row by row with the same rows."""
        modern = builds["matmul"].driver
        old_source = _legacy_source(modern)
        spec = matmul_spec()
        DriverCache().put(CacheEntry(
            kernel=modern.kernel, key="1" * 64, source=old_source, fits={},
            code=code_digest(spec), created_at=1.0, hw_name=H100.name))
        assert warm_start_from_cache([spec]) == [modern.kernel]
        legacy = registry.get(modern.kernel)
        assert "choose_many" not in legacy.namespace
        cols = lattice(ENVELOPES["matmul"])
        got, ok_l = legacy.choose_many(cols)
        want, ok_m = modern.choose_many(cols)
        assert list(ok_l) == list(ok_m)
        for p in modern.program_params:
            assert list(got[p]) == list(want[p])
        plan = compile_plan(legacy, cols)
        assert plan.entries() == compile_plan(modern, cols).entries()


# ---------------------------------------------------------------------------
# The read-throughs: a cached driver of another oracle or build stays put
# ---------------------------------------------------------------------------

class TestReadThrough:
    _PROBES = [{"r": 4096, "c": 2048}, {"r": 16384, "c": 2048}]

    def _colsum(self):
        from repro_torch.introspect import auto_register
        from repro_torch.kernels.reduce import COLSUM, colsum_grid_spec
        return auto_register(COLSUM, colsum_grid_spec(), device="cpu")

    def test_ensure_driver_keeps_to_the_named_oracle(self, clean):
        """With a ``HopperModel`` build of the kernel in the cache,
        ``ensure_driver`` naming another oracle builds on that oracle;
        naming none, it reads the cached driver through."""
        ak = self._colsum()
        kw = dict(repeats=2, max_configs_per_size=16,
                  probe_data=self._PROBES)
        first = ak.ensure_driver(HopperModel(noise=0.03, seed=5), **kw)
        assert not ak.build.from_cache
        registry.clear()
        other = ak.ensure_driver(HopperModel(noise=0.2, seed=11), **kw)
        assert not ak.build.from_cache and other is not first
        assert other.source != first.source
        registry.clear()
        again = ak.ensure_driver(HopperModel(noise=0.2, seed=11), **kw)
        assert ak.build.from_cache and again.source == other.source
        registry.clear()
        assert ak.ensure_driver().source in (first.source, other.source)
        assert registry.stats()["disk_cache_hits"] == 1

    def test_lookup_latest_by_source_hash(self, clean, builds):
        """``lookup_latest(source_hash=...)`` picks one build's entry out of
        several of the same kernel code and card."""
        spec = matmul_spec()
        cache = DriverCache()
        drivers = [builds["matmul"].driver,
                   _build(spec, oracle=HopperModel(noise=0.2, seed=11),
                          register=False).driver]
        for i, drv in enumerate(drivers):
            cache.put(CacheEntry(
                kernel=drv.kernel, key=str(i) * 64, source=drv.source,
                fits={}, code=code_digest(spec), created_at=float(i),
                hw_name=H100.name))
        assert drivers[0].source_hash != drivers[1].source_hash
        for drv in drivers:
            entry = cache.lookup_latest(drv.kernel, hw_name=H100.name,
                                        code=code_digest(spec),
                                        source_hash=drv.source_hash)
            assert entry.source == drv.source
        assert cache.lookup_latest(drivers[0].kernel, source_hash="0" * 16
                                   ) is None


# ---------------------------------------------------------------------------
# The telemetry surface: plan metrics in JSON and Prometheus output
# ---------------------------------------------------------------------------

class TestPlanMetrics:
    def test_exporter_reports_plan_counters(self, clean, builds):
        from repro_torch.telemetry import Telemetry
        driver = builds["matmul"].driver
        register_driver(driver)
        registry.register_plan(compile_plan(driver,
                                            lattice(ENVELOPES["matmul"])))
        tel = Telemetry([matmul_spec()], HopperModel(seed=0), cache=False)
        with tel:
            choose_or_default(driver.kernel, {"m": 1024, "n": 2048,
                                              "k": 512}, {"bm": -1})
        snap = tel.snapshot()
        assert snap["counters"]["choices_by_source"] == {"plan": 1}
        assert snap["counters"]["plan_hits"] == 1
        assert snap["counters"]["choose_many_calls"] >= 1
        assert snap["counters"]["choose_many_rows"] >= 1
        prom = tel.prometheus()
        assert 'klaraptor_choices_total{source="plan"} 1' in prom
        assert "klaraptor_plan_hits 1" in prom
        assert "klaraptor_choose_many_calls" in prom


# ---------------------------------------------------------------------------
# Parity with the JAX package on the same inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_build():
    return RefKlaraptor(V5eSimulator(noise=0.03, seed=7),
                        cache=False).build_driver(
        ref_matmul_spec(), repeats=2, max_configs_per_size=16,
        register=False)


class TestParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pack_shape_and_mix64_equal(self, seed):
        rng = np.random.RandomState(seed)
        for _ in range(200):
            n = int(rng.randint(1, 6))
            shape = tuple(int(v) for v in rng.randint(0, 1 << 62, n,
                                                      dtype=np.int64))
            assert pack_shape(shape) == ref_pack_shape(shape)
            assert _mix64(shape[0]) == ref_mix64(shape[0])
        for v in (0, 1, 2 ** 63 - 1, 2 ** 64 - 1, -1, 2 ** 70 + 5):
            assert _mix64(v) == ref_mix64(v)

    @pytest.mark.parametrize("with_ok", [False, True])
    def test_table_json_and_key_equal(self, with_ok):
        rng = np.random.RandomState(3)
        n = 50
        shapes = {"m": rng.randint(1, 1 << 30, n),
                  "n": np.repeat(rng.randint(1, 4096, n // 2), 2)}
        configs = {"bm": rng.randint(8, 512, n), "bn": rng.randint(8, 512, n)}
        ok = rng.rand(n) > 0.3 if with_ok else None
        args = ("matmul_b16", "some_card", ("m", "n"), ("bm", "bn"), shapes,
                configs, ok)
        mine = LaunchPlanTable.build(*args, tuning_version=2,
                                     source_hash="abc")
        theirs = RefLaunchPlanTable.build(*args, tuning_version=2,
                                          source_hash="abc")
        assert mine.to_json() == theirs.to_json()
        np.testing.assert_array_equal(mine.hashes, theirs.hashes)
        env = {"m": [1, 2, 3], "n": np.array([7, 8])}
        assert plan_key("matmul_b16", "some_card", env, 2, "abc") == \
            ref_plan_key("matmul_b16", "some_card", env, 2, "abc")

    def test_reference_plan_json_loads(self, ref_build):
        cols = {"m": np.array([512, 1024, 2048, 4096, 96]),
                "n": np.array([1024, 2048, 512, 4096, 384]),
                "k": np.array([512, 1024, 512, 2048, 640])}
        theirs = ref_compile_plan(ref_build.driver, cols)
        raw = json.loads(json.dumps(theirs.to_json()))
        mine = LaunchPlanTable.from_json(raw)
        assert len(mine) == len(theirs) > 0
        assert mine.to_json() == theirs.to_json()
        for i in range(5):
            D = {d: int(cols[d][i]) for d in cols}
            assert mine.lookup(D) == theirs.lookup(D)
        assert mine.lookup({"m": 3, "n": 3, "k": 3}) is None
        # and the way back
        back = RefLaunchPlanTable.from_json(mine.to_json())
        assert back.entries() == theirs.entries()

    def test_specialize_evaluates_equal(self):
        """The same program (a Fig. 2-style skeleton over fitted leaves
        that mix D and P), built in both packages from fits of the same
        probe data, specialized on D: equal evaluations, exactly."""
        data = ref_collect(ref_matmul_spec(), V5eSimulator(seed=3),
                           repeats=2, max_configs_per_size=12, seed=5)
        raw = data.to_json()
        port = from_reference_collected(raw)
        fit_vars = {"mem_step": ("m", "bm", "bk"),
                    "cmp_step": ("bm", "bn", "bk"),
                    "ovh_step": ("bm", "bn")}

        def program(rp, fit, data_):
            leaves = {}
            for metric, vars_ in fit_vars.items():
                f = fit(*data_.matrix(metric, vars_), vars_,
                        max_num_degree=2, max_den_degree=2).function
                leaves[metric] = rp.Fitted(metric, f)
            m, n, k = rp.var("m"), rp.var("n"), rp.var("k")
            bm, bn, bk = rp.var("bm"), rp.var("bn"), rp.var("bk")
            steps = (rp.ceil_div(m, bm) * rp.ceil_div(n, bn)
                     * rp.ceil_div(k, bk))
            body = rp.Select(rp.var("m") >= rp.const(2048.0),
                             rp.Max(leaves["mem_step"], leaves["cmp_step"]),
                             leaves["mem_step"] + leaves["cmp_step"])
            return rp.RationalProgram(
                "t", ("m", "n", "k", "bm", "bn", "bk"),
                {"E": steps * (body + leaves["ovh_step"])})

        mine = program(port_rp, fit_auto, port)
        theirs = program(ref_rp, ref_fit_auto, data)
        P = {"bm": np.array([128.0, 256.0, 512.0]),
             "bn": np.array([128.0, 512.0, 256.0]),
             "bk": np.array([256.0, 512.0, 1024.0])}
        for D in ({"m": 4096.0, "n": 2048.0, "k": 1024.0},
                  {"m": 1024.0, "n": 512.0, "k": 4096.0}):
            sm, st = mine.specialize(D), theirs.specialize(D)
            assert sm.inputs == st.inputs == ("bm", "bn", "bk")
            assert sm.count_pieces() == st.count_pieces() == 1
            np.testing.assert_array_equal(sm.eval(P), st.eval(P))
            np.testing.assert_array_equal(sm.eval(P),
                                          mine.eval({**D, **P}))


# ---------------------------------------------------------------------------
# RationalProgram.specialize and the fit_tile memo
# ---------------------------------------------------------------------------

class TestSpecialize:
    def test_expr_folding_matches_eval(self):
        from repro_torch.core import ceil_div, var
        e = ceil_div(var("m"), var("bm")) * ceil_div(var("n"), var("bn"))
        s = e.specialize({"m": 4096, "n": 2048})
        assert s.free_vars() == {"bm", "bn"}
        env = {"bm": np.array([8.0, 128.0]), "bn": np.array([128.0, 256.0])}
        np.testing.assert_array_equal(
            s.eval(env), e.eval({**env, "m": 4096, "n": 2048}))

    def test_select_folds_and_pieces_shrink(self):
        from repro_torch.core import RationalProgram, Select, const, var
        e = Select(var("d") >= const(128), var("p") * 2.0, var("p") * 3.0)
        prog = RationalProgram("t", ("d", "p"), {"E": e})
        assert prog.count_pieces() == 2
        spec = prog.specialize({"d": 256})
        assert spec.count_pieces() == 1           # the decision is gone
        assert spec.inputs == ("p",)
        assert float(spec.eval({"p": 5.0})) == 10.0

    def test_full_binding_gives_constant(self):
        from repro_torch.core import Const, var
        e = (var("a") + var("b")) / var("c")
        s = e.specialize({"a": 6, "b": 2, "c": 4})
        assert isinstance(s, Const) and s.value == 2.0

    def test_partially_bound_fitted_leaf(self, builds):
        """Specializing a program whose fitted leaves mix D and P pins the
        D inputs, so the specialized program evaluates with its own inputs
        only; a partially bound leaf refuses to emit source."""
        from repro_torch.core import Fitted, build_time_program
        fits = {m: f.function for m, f in builds["matmul"].fits.items()}
        prog = build_time_program(matmul_spec(), fits)
        D = {"m": 4096.0, "n": 2048.0, "k": 1024.0}
        sp = prog.specialize(D)
        assert not (set(sp.inputs) & set(D))
        P = {"bm": np.array([64.0, 128.0]), "bn": np.array([128.0, 256.0]),
             "bk": np.array([64.0, 128.0])}
        np.testing.assert_allclose(sp.eval(P), prog.eval({**D, **P}))
        leaf = Fitted("g", fits["mem_step"], {"bm": 8.0})
        with pytest.raises(NotImplementedError):
            leaf.to_source()


class TestFitTileMemo:
    def test_memoized_and_correct(self):
        from repro_torch.core.driver import fit_tile
        fit_tile.cache_clear()
        raw = fit_tile.__wrapped__
        cases = [(4096, 512, 128), (100, 64, 8), (7, 512, 8),
                 (384, 512, 128), (4096, 512, 128)]
        for size, tile, align in cases:
            assert fit_tile(size, tile, align) == raw(size, tile, align)
        info = fit_tile.cache_info()
        assert info.hits >= 1 and info.misses == len(set(cases))

    def test_ops_snap_through_the_memo(self):
        """``ops.matmul``'s f32 tiles go through the memoized fit_tile."""
        from repro_torch.core.driver import fit_tile
        from repro_torch.kernels import ops
        fit_tile.cache_clear()
        x, y = torch.randn(100, 36), torch.randn(36, 20)
        for _ in range(2):
            torch.testing.assert_close(ops.matmul(x, y), x @ y,
                                       atol=2e-4, rtol=2e-4)
        assert fit_tile.cache_info().hits >= 3
