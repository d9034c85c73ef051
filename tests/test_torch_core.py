"""The port's hardware-independent layers held against the JAX package.

The rational-program core (polynomials, rational functions, expression
trees, fitting), the Fig. 2 occupancy program, ``fit_tile`` and the
``random`` probe strategy are the same algorithms in both packages, so fed
the same numpy inputs they must give the same numbers bit for bit: the
port's copies run the same float operations in the same order.  Inputs come
from seeded numpy generators and the reference's own collect run.
"""

import json

import numpy as np
import pytest

from repro.core import fitting as ref_fitting
from repro.core import polynomial as ref_poly
from repro.core import rational as ref_rational
from repro.core import rational_program as ref_rp
from repro.core.collect import batch_seed as ref_batch_seed
from repro.core.collect import collect as ref_collect
from repro.core.device_model import V5eSimulator
from repro.core.driver import fit_tile as ref_fit_tile
from repro.core.kernel_spec import CandidateTable as RefCandidateTable
from repro.core.kernel_spec import matmul_spec as ref_matmul_spec
from repro.core.occupancy import cuda_occupancy_program as ref_occupancy
from repro.core.tuner import _fits_to_json
from repro.search import RandomStrategy as RefRandomStrategy
from repro.search import SearchBudget as RefSearchBudget
from repro.search import SearchContext as RefSearchContext

from repro_torch.core import fitting as port_fitting
from repro_torch.core import polynomial as port_poly
from repro_torch.core import rational as port_rational
from repro_torch.core import rational_program as port_rp
from repro_torch.core.collect import batch_seed, from_reference_collected
from repro_torch.core.driver import fit_tile as port_fit_tile
from repro_torch.core.kernel_spec import CandidateTable
from repro_torch.core.occupancy import cuda_occupancy_program
from repro_torch.core.tuner import fitresult_from_json
from repro_torch.search import RandomStrategy, SearchBudget, SearchContext

METRICS = ("mem_step", "cmp_step", "ovh_step")
FIT_VARS = ("bm", "bn", "bk")


@pytest.fixture(scope="module")
def ref_data():
    """A reference CollectedData (V5e simulator) as its plain JSON dict."""
    data = ref_collect(ref_matmul_spec(), V5eSimulator(seed=3), repeats=2,
                       max_configs_per_size=12, seed=5)
    return data.to_json()


@pytest.fixture(scope="module")
def both_data(ref_data):
    from repro.core.collect import CollectedData as RefCollectedData
    return (RefCollectedData.from_json(ref_data),
            from_reference_collected(ref_data))


def test_collected_data_carries_over(ref_data, both_data):
    ref, port = both_data
    assert port.spec_name == ref.spec_name
    assert len(port) == len(ref) > 0
    for v in ref.columns:
        np.testing.assert_array_equal(port.columns[v], ref.columns[v])
    for m in ref.metrics:
        np.testing.assert_array_equal(port.metrics[m], ref.metrics[m])
    np.testing.assert_array_equal(port.grid_steps, ref.grid_steps)
    np.testing.assert_array_equal(port.stage_bytes, ref.vmem_stage_bytes)
    assert port.n_probe_executions == ref.n_probe_executions


@pytest.mark.parametrize("metric", METRICS)
def test_design_matrix_identical(both_data, metric):
    ref, port = both_data
    Xr, yr = ref.matrix(metric, FIT_VARS)
    Xp, yp = port.matrix(metric, FIT_VARS)
    np.testing.assert_array_equal(Xp, Xr)
    np.testing.assert_array_equal(yp, yr)
    exps = port_poly.monomial_exponents((2, 2, 2), 4)
    assert exps == ref_poly.monomial_exponents((2, 2, 2), 4)
    np.testing.assert_array_equal(port_poly.design_matrix(Xp, exps),
                                  ref_poly.design_matrix(Xr, exps))


@pytest.mark.parametrize("metric", METRICS)
def test_fit_auto_identical(both_data, metric):
    ref, port = both_data
    fr = ref_fitting.fit_auto(*ref.matrix(metric, FIT_VARS), FIT_VARS,
                              max_num_degree=2, max_den_degree=2)
    fp = port_fitting.fit_auto(*port.matrix(metric, FIT_VARS), FIT_VARS,
                               max_num_degree=2, max_den_degree=2)
    assert (fp.num_bounds, fp.den_bounds) == (fr.num_bounds, fr.den_bounds)
    for side in ("numerator", "denominator"):
        pr, pp = getattr(fr.function, side), getattr(fp.function, side)
        assert pp.exponents == pr.exponents
        np.testing.assert_array_equal(pp.coeffs, pr.coeffs)
    assert fp.rel_error == fr.rel_error
    assert fp.cv_error == fr.cv_error


def test_fitresult_from_json(both_data):
    ref, _ = both_data
    fits = {m: ref_fitting.fit_auto(*ref.matrix(m, FIT_VARS), FIT_VARS,
                                    max_num_degree=2, max_den_degree=1)
            for m in METRICS}
    raw = json.loads(json.dumps(_fits_to_json(fits)))
    port = fitresult_from_json(raw)
    X, _ = ref.matrix("mem_step", FIT_VARS)
    for m in METRICS:
        np.testing.assert_array_equal(port[m].function(X), fits[m].function(X))
        assert port[m].n_params == fits[m].n_params
        assert port[m].num_bounds == fits[m].num_bounds


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rational_function_evaluations_equal(seed):
    rng = np.random.RandomState(seed)
    names = ("a", "b")
    exps = ref_poly.monomial_exponents((2, 2), 3)
    num_c, den_c = rng.randn(len(exps)), rng.randn(len(exps))
    den_c[0] = 50.0   # keep the denominator away from zero
    X = rng.uniform(1.0, 9.0, size=(64, 2))

    def build(poly_mod, rat_mod):
        return rat_mod.RationalFunction(
            poly_mod.Polynomial(names, tuple(exps), num_c.copy()),
            poly_mod.Polynomial(names, tuple(exps), den_c.copy()))

    fr = build(ref_poly, ref_rational)
    fp = build(port_poly, port_rational)
    np.testing.assert_array_equal(fp(X), fr(X))
    assert fp.to_source() == fr.to_source()
    assert fp.to_json() == fr.to_json()


def _tree(rp):
    a, b, c = rp.var("a"), rp.var("b"), rp.var("c")
    return rp.Select(
        rp.Ceil(a / b) > rp.Floor(c * rp.const(2.0)),
        rp.Max(a, b) + rp.ceil_div(c, b),
        rp.Min(rp.floor_div(a, c), b - rp.const(3.0)),
    )


def _nested_tree(rp):
    a, b = rp.var("a"), rp.var("b")
    inner = rp.Select(a <= b, rp.Floor(a / rp.const(3.0)), rp.Ceil(b))
    return rp.Select(inner >= rp.const(2.0), inner * a, rp.Max(inner, b))


@pytest.mark.parametrize("make", [_tree, _nested_tree])
def test_expr_trees_evaluate_equal(make):
    rng = np.random.RandomState(11)
    env = {v: rng.uniform(0.5, 20.0, size=256) for v in ("a", "b", "c")}
    er, ep = make(ref_rp), make(port_rp)
    np.testing.assert_array_equal(ep.eval(env), er.eval(env))
    assert ep.to_source(vector=True) == er.to_source(vector=True)
    assert ep.to_source() == er.to_source()
    assert ep.count_pieces() == er.count_pieces()
    bound = {"a": 7.0}
    np.testing.assert_array_equal(ep.specialize(bound).eval(env),
                                  er.specialize(bound).eval(env))


def test_occupancy_program_matches_reference():
    T, R, Z = np.meshgrid(
        np.arange(32, 1025, 32, dtype=np.float64),
        np.array([16, 32, 64, 96, 128, 168, 255], dtype=np.float64),
        np.array([0, 1024, 8192, 49152, 100000, 232448, 233472, 240000],
                 dtype=np.float64), indexing="ij")
    env = {"R_max": 65536.0, "Z_max": 233472.0, "T_max": 2048.0,
           "B_max": 32.0, "W_max": 64.0, "R": R.ravel(), "Z": Z.ravel(),
           "T": T.ravel()}
    ref, port = ref_occupancy(), cuda_occupancy_program()
    assert port.count_pieces() == ref.count_pieces() == 5
    for out in ("B_active", "W_active", "E"):
        np.testing.assert_array_equal(port.eval(env, out), ref.eval(env, out))


def test_fit_tile_matches_reference():
    for size in (8, 24, 64, 96, 128, 500, 512, 2048, 4096, 128256):
        for tile in (8, 16, 48, 64, 128, 384, 512, 1024, 8192):
            for align in (1, 8, 16, 128):
                assert port_fit_tile(size, tile, align) == \
                    ref_fit_tile(size, tile, align), (size, tile, align)


def test_batch_seed_matches_reference():
    for seed in (0, 1, 42):
        for i in range(30):
            assert batch_seed(seed, i) == ref_batch_seed(seed, i)


def _drain(strategy, ledger):
    picks = []
    while True:
        ask = strategy.ask(ledger)
        if ask is None:
            return picks
        picks.append(np.asarray(ask.indices).tolist())
        ledger.charge(len(ask.indices), 0.0)
        strategy.tell(ask.indices, np.ones(len(ask.indices)))


@pytest.mark.parametrize("seed,max_rows", [(0, None), (3, 48), (17, 20)])
def test_random_strategy_selects_same_rows(seed, max_rows):
    D = {"m": 512, "n": 1024, "k": 256}
    ref_table = ref_matmul_spec().candidates(D)
    table = CandidateTable(ref_table.params, dict(ref_table.columns))
    assert len(table) > 32
    picks = []
    for strat_cls, ctx_cls, tab, budget_cls in (
            (RefRandomStrategy, RefSearchContext, ref_table, RefSearchBudget),
            (RandomStrategy, SearchContext, table, SearchBudget)):
        s = strat_cls(batch_size=8)
        s.begin_run()
        s.start(ctx_cls(table=tab, rng=np.random.RandomState(seed), D=D,
                        default_repeats=2, max_rows=max_rows))
        picks.append(_drain(s, budget_cls().ledger()))
    assert picks[1] == picks[0]
    assert sum(len(p) for p in picks[1]) > 0
    assert isinstance(ref_table, RefCandidateTable)
