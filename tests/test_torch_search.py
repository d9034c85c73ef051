"""The port's budgeted online search held against the JAX package.

The strategies are hardware-independent, so fed the same candidate table,
context, budget ledger and probe times they must ask for the same rows, at
the same repeats and caps, bit for bit, as the reference's: both packages'
own budget cut (``search.driver._evaluate``) runs between the asks, over a
fake oracle that returns a seeded times vector.  The fitter the surrogate
prices rows with is held against the reference's on the surrogate's own
sample.  Then the reference's ``tests/test_search.py`` (all but
``TestEscalation``) runs on the port, by name and with its bars, on the f32
SIMT matmul (``matmul_spec(4)``, 88 feasible tiles at 4096^3) under
``HopperModel`` -- the bf16 specs are the 2-9 compiled tiles, where a
quarter of an exhaustive pass buys one or two probes.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.search as ref_search
import repro.search.driver as ref_driver
from repro.core import fitting as ref_fitting
from repro.core.collect import default_probe_data as ref_default_probe_data
from repro.core.device_model import RowProbe as RefRowProbe
from repro.core.kernel_spec import CandidateTable as RefCandidateTable
from repro.core.kernel_spec import moe_gmm_spec as ref_moe_gmm_spec

import repro_torch.search as port_search
import repro_torch.search.driver as port_driver
import repro_torch.search.surrogate as port_surrogate
from repro_torch.core import (H100, CandidateTable, HopperModel, Klaraptor,
                              RowProbe, exhaustive_search,
                              flash_attention_spec, gmm_probe_data,
                              matmul_spec, search_best, ssd_probe_data)
from repro_torch.core import fitting as port_fitting
from repro_torch.core.collect import collect
from repro_torch.search import (STRATEGIES, SearchBudget, default_budget,
                                make_strategy, run_search)

D_MM = {"m": 4096, "n": 4096, "k": 4096}
D_PARITY = {"m": 2048, "n": 2048, "k": 2048}
PARAMS = ("bm", "bn", "bk")


# -- parity with the reference, bit for bit ------------------------------------

@pytest.fixture(scope="module")
def parity_table():
    """The port's f32 matmul table at N 2048 (88 rows), its analytic cost
    hint and a times vector from a numpy seed."""
    spec = matmul_spec(4)
    table = spec.candidates(D_PARITY, H100)
    tt = spec.traffic_table(D_PARITY, table, H100)
    rng = np.random.RandomState(0)
    times = HopperModel().true_time_batch(tt) * np.exp(
        rng.normal(0.0, 0.04, len(table)))
    return table, port_driver.analytic_cost_hint(tt, H100), times


class _Rows:
    """A traffic table stand-in: ``select`` hands the row indices on."""

    def select(self, idx):
        return np.asarray(idx)


class _TimesOracle:
    """Probes return ``times[idx]`` for every repeat, as the package's own
    ``RowProbe`` (the two packages' probes have different fields)."""

    def __init__(self, times, probe_cls):
        self.times, self.probe_cls = times, probe_cls

    def probe_rows(self, idx, rng, repeats):
        t = self.times[idx]
        reps = np.asarray(repeats)
        given = {"total_time_s": t, "device_seconds": t * reps,
                 "repeats": reps}
        return self.probe_cls(**{
            f.name: given.get(f.name, np.zeros(len(idx)))
            for f in dataclasses.fields(self.probe_cls)})


def _asks(pkg, driver, table_cls, probe_cls, parity_table, name, budget_kw,
          seed):
    """Every ask of strategy ``name`` under one package's budget ledger and
    budget cut: (indices, repeats, device_seconds_cap) per round, and the
    ledger's spend."""
    table, hint, times = parity_table
    ledger = pkg.SearchBudget(**budget_kw).ledger()
    strategy = pkg.make_strategy(name)
    strategy.begin_run()
    strategy.start(pkg.SearchContext(
        table=table_cls(table.params, dict(table.columns)),
        rng=np.random.RandomState(seed), D=D_PARITY, default_repeats=1,
        cost_hint=hint.copy(), max_rows=None))
    oracle = _TimesOracle(times, probe_cls)
    calib = driver._CostCalibration()
    rounds = []
    while not ledger.exhausted():
        ask = strategy.ask(ledger)
        if ask is None:
            break
        rounds.append((np.asarray(ask.indices).tolist(),
                       np.asarray(ask.repeats).tolist(),
                       ask.device_seconds_cap))
        out = driver._evaluate(ask, _Rows(), oracle,
                               np.random.RandomState(0), ledger, hint, calib)
        if out is None:
            break
        strategy.tell(out[0], out[1].total_time_s)
    return rounds, ledger.spent_executions, ledger.spent_device_seconds


def _budget_kw(kind, times):
    if kind == "executions":
        return {"max_executions": 40}
    return {"max_device_seconds": 0.25 * float(np.sum(times))}


@pytest.mark.parametrize("seed", [5, 135])
@pytest.mark.parametrize("kind", ["executions", "device_seconds"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_asks_identical_to_reference(parity_table, name, kind,
                                              seed):
    """At seed 135 the surrogate's first exploit batch is fitted on 16 rows
    with 4 distinct values per column: before the ``fit_auto`` repair the
    port's fit fell back to an interpolating polynomial there and its asks
    left the reference's from the third (executions) or fourth
    (device-seconds) on."""
    kw = _budget_kw(kind, parity_table[2])
    ref = _asks(ref_search, ref_driver, RefCandidateTable, RefRowProbe,
                parity_table, name, kw, seed)
    port = _asks(port_search, port_driver, CandidateTable, RowProbe,
                 parity_table, name, kw, seed)
    assert port == ref
    assert len(port[0]) >= 1 and port[1] > 0


def _surrogate_sample(parity_table, seed=135):
    """The 16 rows the surrogate explores before its first fit, as it
    hands them to ``fit_auto`` (row order, observed times)."""
    table, hint, times = parity_table
    s = make_strategy("surrogate")
    s.begin_run()
    s.start(port_search.SearchContext(
        table=table, rng=np.random.RandomState(seed), D=D_PARITY,
        default_repeats=1, cost_hint=hint.copy(), max_rows=None))
    ledger = SearchBudget(max_executions=40).ledger()
    for _ in range(2):
        ask = s.ask(ledger)
        ledger.charge(len(ask.indices), 0.0)
        s.tell(ask.indices, times[ask.indices])
    seen = np.flatnonzero(~np.isnan(s._times))
    X = np.stack([table[p][seen].astype(np.float64) for p in PARAMS], axis=1)
    return X, times[seen]


def test_fit_auto_on_the_surrogate_sample_matches_reference(parity_table):
    X, y = _surrogate_sample(parity_table)
    assert len(X) == 16
    assert [len(np.unique(X[:, j])) for j in range(3)] == [4, 4, 4]
    ref = ref_fitting.fit_auto(X, y, PARAMS, max_num_degree=2,
                               max_den_degree=1)
    port = port_fitting.fit_auto(X, y, PARAMS, max_num_degree=2,
                                 max_den_degree=1)
    assert (ref.num_bounds, ref.den_bounds) == ((1, 1, 1), (0, 0, 0))
    assert (port.num_bounds, port.den_bounds, port.n_params) == \
        (ref.num_bounds, ref.den_bounds, ref.n_params)
    for part in ("numerator", "denominator"):
        a = getattr(ref.function, part).coeffs
        b = getattr(port.function, part).coeffs
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=0.0)
    assert port.cv_error == ref.cv_error
    assert port.n_params <= len(np.unique(X, axis=0))


def test_fit_auto_fallback_fits_no_more_monomials_than_points():
    """Six distinct points cannot carry the smallest rational bounds (9
    parameters), so both packages fall back to a polynomial.  The
    reference's fits its (2, 2, 2) monomials, 23 on 6 points, and
    interpolates them; the port's lowers the bound until the monomials fit
    the points (a divergence by design)."""
    rng = np.random.RandomState(4)
    X = np.array([[64, 64, 8], [128, 64, 16], [128, 128, 32],
                  [64, 128, 64], [256, 64, 32], [64, 256, 16]], float)
    y = 1e-7 * X[:, 0] * X[:, 1] * np.exp(rng.normal(0.0, 0.05, len(X)))
    ref = ref_fitting.fit_auto(X, y, PARAMS, max_num_degree=2,
                               max_den_degree=1)
    port = port_fitting.fit_auto(X, y, PARAMS, max_num_degree=2,
                                 max_den_degree=1)
    assert ref.n_params == 23 and ref.den_bounds == (0, 0, 0)
    assert port.den_bounds == (0, 0, 0)
    assert port.n_params <= len(X)
    assert np.all(np.isfinite(port.function(X)))


# -- the reference's tests/test_search.py on the port ------------------------

@pytest.fixture(scope="module")
def sim():
    return HopperModel(noise=0.04, seed=11)


@pytest.fixture(scope="module")
def exhaustive_mm(sim):
    return exhaustive_search(matmul_spec(4), sim, D_MM, H100)


class TestBudget:
    def test_split_conserves_totals(self):
        b = SearchBudget(max_executions=10, max_device_seconds=1.0)
        parts = b.split(3)
        assert sum(p.max_executions for p in parts) == 10
        assert sum(p.max_device_seconds for p in parts) == pytest.approx(1.0)

    def test_unbounded_axes_stay_unbounded(self):
        parts = SearchBudget().split(4)
        assert all(p.max_executions is None for p in parts)
        assert all(p.max_device_seconds is None for p in parts)

    @pytest.mark.parametrize("name", sorted(STRATEGIES))
    def test_execution_budget_never_exceeded(self, sim, name):
        budget = SearchBudget(max_executions=17)
        r = run_search(matmul_spec(4), sim, D_MM, strategy=name,
                       budget=budget, seed=3)
        assert 0 < r.n_probe_executions <= 17
        assert r.best_config is not None

    @pytest.mark.parametrize("name", sorted(STRATEGIES))
    def test_device_seconds_budget_never_exceeded(self, sim, name,
                                                  exhaustive_mm):
        _, _, _, exhaustive_s = exhaustive_mm
        cap = 0.1 * exhaustive_s
        r = run_search(matmul_spec(4), sim, D_MM, strategy=name,
                       budget=SearchBudget(max_device_seconds=cap), seed=3)
        assert 0.0 < r.probe_device_seconds <= cap
        assert r.best_config is not None

    def test_both_axes_enforced_together(self, sim, exhaustive_mm):
        _, _, _, exhaustive_s = exhaustive_mm
        budget = SearchBudget(max_executions=40,
                              max_device_seconds=0.05 * exhaustive_s)
        for name in sorted(STRATEGIES):
            r = run_search(matmul_spec(4), sim, D_MM, strategy=name,
                           budget=budget, seed=9)
            assert r.n_probe_executions <= 40, name
            assert r.probe_device_seconds <= 0.05 * exhaustive_s, name


class TestDeterminism:
    @pytest.mark.parametrize("name", sorted(STRATEGIES))
    def test_fixed_seed_reproduces_run(self, sim, name):
        budget = SearchBudget(max_executions=48)
        a = run_search(matmul_spec(4), sim, D_MM, strategy=name,
                       budget=budget, seed=17)
        b = run_search(matmul_spec(4), sim, D_MM, strategy=name,
                       budget=budget, seed=17)
        assert a.best_config == b.best_config
        assert a.n_probe_executions == b.n_probe_executions
        assert a.probe_device_seconds == pytest.approx(
            b.probe_device_seconds)

    def test_different_seed_may_differ_but_stays_valid(self, sim):
        budget = SearchBudget(max_executions=24)
        r = run_search(matmul_spec(4), sim, D_MM, strategy="random",
                       budget=budget, seed=101)
        assert set(r.best_config) == {"bm", "bn", "bk"}


def _ratio(sim, spec, r, best_t) -> float:
    times = sim.true_time_batch(spec.traffic_table(
        D_MM, spec.candidates(D_MM, H100).select(np.array([r.best_index])),
        H100))
    return best_t / float(times[0])


class TestStrategyQuality:
    def test_halving_beats_random_at_equal_budget(self, sim, exhaustive_mm):
        """Successive halving's noise-aware refinement must reach at least
        random's selection ratio for the same device-second budget."""
        best_P, best_t, _, exhaustive_s = exhaustive_mm
        budget = SearchBudget(max_device_seconds=0.25 * exhaustive_s)
        spec = matmul_spec(4)

        def ratio(name):
            r = run_search(spec, sim, D_MM, strategy=name, budget=budget,
                           seed=29)
            return _ratio(sim, spec, r, best_t)

        assert ratio("successive_halving") >= ratio("random")

    def test_some_strategy_is_good_within_quarter_budget(self, sim,
                                                         exhaustive_mm):
        """The acceptance bar: ratio >= 0.85 at <= 25% of exhaustive probe
        device-seconds on matmul."""
        best_P, best_t, _, exhaustive_s = exhaustive_mm
        budget = SearchBudget(max_device_seconds=0.25 * exhaustive_s)
        spec = matmul_spec(4)
        ratios = {}
        for name in sorted(STRATEGIES):
            r = run_search(spec, sim, D_MM, strategy=name, budget=budget,
                           seed=29)
            ratios[name] = _ratio(sim, spec, r, best_t)
        assert max(ratios.values()) >= 0.85, ratios

    def test_search_best_facade(self, sim):
        r = search_best(matmul_spec(4), sim, D_MM, strategy="surrogate",
                        budget=SearchBudget(max_executions=64), seed=5)
        assert r.kernel == "matmul_b32"
        assert r.strategy["name"] == "surrogate"
        assert set(r.best_config) == {"bm", "bn", "bk"}
        assert r.n_probe_executions <= 64


class TestCollectIntegration:
    def test_cache_key_separates_strategies(self, sim, tmp_path,
                                            monkeypatch):
        """Same spec, same hyperparams, different strategy -> different
        cache artifact (a rebuild, not a hit)."""
        monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "c"))
        kl = Klaraptor(HopperModel(noise=0.03, seed=5))
        first = kl.build_driver(matmul_spec(4), repeats=2,
                                max_configs_per_size=16, register=False,
                                strategy="random")
        assert not first.from_cache
        second = kl.build_driver(matmul_spec(4), repeats=2,
                                 max_configs_per_size=16, register=False,
                                 strategy="lhs")
        assert not second.from_cache
        again = kl.build_driver(matmul_spec(4), repeats=2,
                                max_configs_per_size=16, register=False,
                                strategy="random")
        assert again.from_cache

    def test_collect_respects_total_budget(self, sim):
        budget = SearchBudget(max_executions=60)
        data = collect(matmul_spec(4), sim, repeats=2, budget=budget)
        assert 0 < data.n_probe_executions <= 60

    def test_halving_carries_survivors_across_sizes(self, sim):
        """With a multi-size collect, successive halving probes fewer rows
        at the later sizes (only survivors), not the whole table."""
        strat = make_strategy("successive_halving")
        data = collect(matmul_spec(4), sim,
                       probe_data=[{"m": 256, "n": 256, "k": 256},
                                   {"m": 1024, "n": 1024, "k": 1024}],
                       repeats=2, strategy=strat)
        cols = data.columns
        small = cols["m"] == 256
        large = cols["m"] == 1024
        # distinct configs probed at the large size <= survivors of small
        small_cfgs = {tuple(r) for r in np.stack(
            [cols[p][small] for p in PARAMS], axis=1)}
        large_cfgs = {tuple(r) for r in np.stack(
            [cols[p][large] for p in PARAMS], axis=1)}
        assert 0 < len(large_cfgs) < len(small_cfgs)

    def test_probe_hints_override_default_sweep(self):
        """The port states the reference's ``probe_hints`` as the specs'
        probe-data functions: few experts for the grouped matmul, a fixed
        ``chunkflops`` and the caller's bh for the SSD scan."""
        pts = gmm_probe_data()
        assert {p["e"] for p in pts} == {2, 4} == {
            p["e"] for p in ref_default_probe_data(ref_moe_gmm_spec())}
        assert ssd_probe_data(bhs=(3,), seqs=(128,)) == \
            [{"bh": 3, "s": 128, "chunkflops": 1}]


# -- the port's small tables, defaults and errors -----------------------------

@pytest.mark.parametrize("spec", [matmul_spec(), flash_attention_spec()],
                         ids=lambda s: s.name)
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_budget_no_first_row_fits_finds_nothing(sim, spec, name):
    """The bf16 tables are the compiled tiles (9 and 4 rows): a
    device-seconds budget below the cheapest row's time probes nothing and
    returns no config, as the reference does, rather than raising."""
    D = {"bh": 64, "sq": 8192, "skv": 8192} if "flash" in spec.name \
        else D_MM
    table = spec.candidates(D, H100)
    assert len(table) == (4 if "flash" in spec.name else 9)
    cheapest = float(np.min(sim.true_time_batch(
        spec.traffic_table(D, table, H100))))
    r = run_search(spec, sim, D, strategy=name,
                   budget=SearchBudget(max_device_seconds=0.5 * cheapest),
                   seed=29)
    assert r.best_config is None and r.best_index is None
    assert r.n_probe_executions == 0 and r.probe_device_seconds == 0.0
    assert r.n_candidates == len(table)


def test_default_budget():
    assert default_budget(9).max_executions == 8
    assert default_budget(9).max_device_seconds is None
    assert default_budget(88).max_executions == 22
    r = run_search(matmul_spec(), HopperModel(seed=1), D_MM, seed=2)
    assert r.budget == {"max_executions": 8, "max_device_seconds": None}
    assert r.n_probe_executions == 8 and r.n_candidates == 9


def test_hw_defaults_to_the_oracles(sim):
    """Without ``hw`` the search enumerates the oracle's hardware, not a
    constant table: an oracle with half the opt-in shared memory leaves
    out the f32 tiles whose ring needs more."""
    small = dataclasses.replace(H100, name="half_smem",
                                smem_per_block_optin=H100.smem_per_block_optin
                                // 2,
                                smem_per_sm=H100.smem_per_sm // 2)
    oracle = HopperModel(small, noise=0.04, seed=11)
    spec = matmul_spec(4)
    assert len(spec.candidates(D_MM, small)) < len(spec.candidates(D_MM, H100))
    budget = SearchBudget(max_executions=30)
    r = run_search(spec, oracle, D_MM, strategy="lhs", budget=budget,
                   seed=4)
    assert r.n_candidates == len(spec.candidates(D_MM, small))
    named = run_search(spec, oracle, D_MM, strategy="lhs", budget=budget,
                       seed=4, hw=small)
    assert (r.best_config, r.n_probe_executions) == \
        (named.best_config, named.n_probe_executions)


def test_run_search_rejects_a_foreign_budget_and_an_empty_table(sim):
    with pytest.raises(TypeError, match="SearchBudget"):
        run_search(matmul_spec(4), sim, D_MM,
                   budget=ref_search.SearchBudget(max_executions=8))
    with pytest.raises(ValueError, match="no feasible configuration"):
        run_search(matmul_spec(4), sim, {"m": 4, "n": 4, "k": 4})


def test_search_best_without_an_oracle_needs_the_card():
    """No oracle means the port's kernels timed on the card; on the CPU
    that raises instead of falling back to a model."""
    with pytest.raises(RuntimeError, match="CUDA"):
        search_best(matmul_spec(4), None, D_MM)


@pytest.mark.parametrize("error", port_surrogate.FIT_ERRORS)
def test_surrogate_keeps_exploring_when_its_fit_raises(sim, monkeypatch,
                                                       error):
    """A fit that raises one of the errors the fit can raise leaves the
    surrogate exploring its coverage order until the budget is spent."""
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        raise error("no fit")

    monkeypatch.setattr(port_surrogate, "fit_auto", failing)
    r = run_search(matmul_spec(4), sim, D_MM, strategy="surrogate",
                   budget=SearchBudget(max_executions=40), seed=3)
    assert calls and r.best_config is not None
    assert r.n_probe_executions == 40 and r.n_rounds == 5


def test_surrogate_lets_an_unrelated_error_through(sim, monkeypatch):
    def broken(*args, **kw):
        raise KeyError("bm")

    monkeypatch.setattr(port_surrogate, "fit_auto", broken)
    with pytest.raises(KeyError):
        run_search(matmul_spec(4), sim, D_MM, strategy="surrogate",
                   budget=SearchBudget(max_executions=40), seed=3)


def test_collect_and_build_resolve_every_strategy(sim, tmp_path,
                                                  monkeypatch):
    """Importing the package registers all four, so ``collect`` and
    ``Klaraptor.build_driver`` take each by name."""
    assert sorted(STRATEGIES) == ["lhs", "random", "successive_halving",
                                  "surrogate"]
    monkeypatch.setenv("KLARAPTOR_CACHE_DIR", str(tmp_path / "c"))
    for name in sorted(STRATEGIES):
        data = collect(matmul_spec(4), sim,
                       probe_data=[{"m": 512, "n": 512, "k": 512}],
                       repeats=1, max_configs_per_size=12, strategy=name)
        assert 0 < data.n_probe_executions <= 12, name


def test_bench_search_smoke_on_the_cpu(tmp_path):
    from repro_torch.benchmarks import bench_search

    out = tmp_path / "search.json"
    lines = bench_search.main(["--device", "cpu", "--smoke", "--out",
                               str(out)])
    assert len(lines) == len(STRATEGIES)
    assert all(ln.startswith("search/matmul_b32/") for ln in lines)
    report = json.loads(out.read_text())
    assert report["oracle"] == "HopperModel"
    assert report["kernels_with_good_strategy"] == ["matmul_b32"]
    for row in report["results"]:
        assert row["device_seconds_fraction"] <= bench_search.BUDGET_FRACTION
        assert row["n_cut_rows"] >= 0
    with pytest.raises(SystemExit):
        bench_search.main(["--device", "cpu", "--smoke", "--out",
                           str(bench_search._REFERENCE_REPORT)])
