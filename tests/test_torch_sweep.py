"""The port's config-axis sweep (``sweep.run_grid``: every (seed × config)
cell a lane of one batched run) against the reference's ``run_grid`` and
against the port's sequential ``GATrainer.run`` per cell, bit for bit:
states, fronts, ``unique_evals`` and ``cache_hits`` under the shared dedup
bound, dedup on and off; the constraint and baseline axes, ``with_hypers``
on unswept axes and the ``grid_cells`` layout (``tests/test_sweep.py``)."""
import dataclasses

import numpy as np
import pytest

from repro.core import GAConfig as JCfg, engine as jeng, sweep as jsweep
from repro.core.genome import MLPTopology as JTopo
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine, sweep
from test_torch_interop import assert_bits_equal, assert_states_equal

SEEDS = (0, 1)
MUTATION_RATES = (0.02, 0.05)
RUN = dict(pop_size=16, generations=4)

_runs: dict = {}


def _grids(ds, dedup):
    """The reference's grid and the port's (cached per process)."""
    if dedup not in _runs:
        jp = jeng.Problem.from_data(JTopo(ds.topology), ds.x_train, ds.y_train,
                                    JCfg(**RUN, dedup=dedup))
        tp = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                      GAConfig(**RUN, dedup=dedup), device="cpu")
        _runs[dedup] = (jsweep.run_grid(jp, SEEDS, mutation_rates=MUTATION_RATES),
                        sweep.run_grid(tp, SEEDS, mutation_rates=MUTATION_RATES))
    return _runs[dedup]


def _trainer(ds, baseline_acc=1.0, **kw):
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                   GAConfig(**RUN, **kw), baseline_acc=baseline_acc, device="cpu")
    return tr, tr.run()[0]


def assert_port_states_equal(a, b, msg):
    from repro_torch.core.interop import state_to_numpy

    la, lb = state_to_numpy(a), state_to_numpy(b)
    assert set(la) == set(lb), msg
    for name in la:
        assert_bits_equal(la[name], lb[name], f"{msg}: {name}")


@pytest.mark.parametrize("dedup", [True, False])
def test_grid_matches_reference(bc_dataset, dedup):
    ref, port = _grids(bc_dataset, dedup)
    assert port.shape == ref.shape == (2, 1, 2, 1, 1) and port.n_cells == 4
    for k in ("seed", "crossover_rate", "mutation_rate_gene", "max_acc_loss",
              "baseline_acc"):
        assert_bits_equal(ref.cells[k], port.cells[k], k)
    for i in range(port.n_cells):
        assert port.cell(i) == ref.cell(i)
        assert_states_equal(ref.state_at(i), port.state_at(i), msg=f"cell {i}")
        assert (port.unique_evals(i), port.cache_hits(i)) == (ref.unique_evals(i),
                                                               ref.cache_hits(i))
    for k in range(4):
        assert_bits_equal(ref.aux[k], port.aux[k], f"aux[{k}]")


@pytest.mark.parametrize("dedup", [True, False])
def test_grid_matches_trainer_double_loop(bc_dataset, dedup):
    """Every cell equals the sequential trainer with that cell's GAConfig:
    states (cache included), fronts and the dedup accounting."""
    _, port = _grids(bc_dataset, dedup)
    i = 0
    for s in SEEDS:
        for pm in MUTATION_RATES:
            tr, state = _trainer(bc_dataset, dedup=dedup, seed=s, mutation_rate_gene=pm)
            assert_port_states_equal(port.state_at(i), state, f"cell {port.cell(i)}")
            f_tr, f_grid = tr.front(state), port.front_at(i)
            for k in ("objectives", "genomes"):
                assert_bits_equal(f_tr[k], f_grid[k], f"front {k}")
            if dedup:
                assert port.unique_evals(i) == tr.unique_evals
                assert port.cache_hits(i) == tr.cache_hits
                assert port.unique_evals(i) <= (RUN["generations"] + 1) * RUN["pop_size"]
            i += 1
    assert len(port.fronts()) == port.n_cells


def test_grid_constraint_axis_sweeps_feasibility(bc_dataset, bc_float):
    ds = bc_dataset
    base = float(bc_float.train_acc)
    problem = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                       GAConfig(**RUN), baseline_acc=base, device="cpu")
    bounds = (0.02, 0.5)
    result = sweep.run_grid(problem, [0], max_acc_losses=bounds)
    assert result.shape == (1, 1, 1, 2, 1)
    n_feas = []
    for i, mal in enumerate(bounds):
        _, state = _trainer(ds, baseline_acc=base, seed=0, max_acc_loss=mal)
        assert_port_states_equal(result.state_at(i), state, f"max_acc_loss={mal}")
        n_feas.append(int((result.state_at(i).viol <= 0).sum()))
    assert n_feas[1] >= n_feas[0]


def test_grid_baseline_axis_sweeps_constraint_pressure(bc_dataset, bc_float):
    ds = bc_dataset
    base = float(bc_float.train_acc)
    problem = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                       GAConfig(**RUN), baseline_acc=base, device="cpu")
    baselines = (0.2, base)
    result = sweep.run_grid(problem, [0], baseline_accs=baselines)
    assert result.shape == (1, 1, 1, 1, 2)
    assert_bits_equal(np.float32(baselines), result.cells["baseline_acc"], "baselines")
    n_feas = []
    for i, ba in enumerate(baselines):
        _, state = _trainer(ds, baseline_acc=ba, seed=0)
        assert_port_states_equal(result.state_at(i), state, f"baseline_acc={ba}")
        n_feas.append(int((result.state_at(i).viol <= 0).sum()))
    assert n_feas[0] >= n_feas[1]


def test_grid_honors_with_hypers_on_unswept_axes(bc_dataset):
    ds = bc_dataset
    problem = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                       GAConfig(pop_size=8, generations=1), device="cpu")
    tight = problem.with_hypers(max_acc_loss=0.05)
    result = sweep.run_grid(tight, [0], mutation_rates=MUTATION_RATES)
    assert (result.cells["max_acc_loss"] == np.float32(0.05)).all()
    states, _, _ = engine.run_batch(tight, [0], generations=1)
    assert_port_states_equal(result.state_at(0), engine.state_at(states, 0), "with_hypers")


@pytest.mark.parametrize("cfg_kw", [{}, dict(crossover_rate=0.9, max_acc_loss=0.05)])
def test_grid_cells_layout_matches_reference(cfg_kw):
    kw = dict(mutation_rates=[0.1, 0.2, 0.3], baseline_accs=[0.5, 0.9])
    port = sweep.grid_cells([3, 4], cfg=GAConfig(**cfg_kw), **kw)
    ref = jsweep.grid_cells([3, 4], cfg=JCfg(**cfg_kw), **kw)
    assert port["shape"] == ref["shape"] == (2, 1, 3, 1, 2)
    for k in ("seed", "crossover_rate", "mutation_rate_gene", "max_acc_loss",
              "baseline_acc"):
        assert_bits_equal(ref[k], port[k], k)
    np.testing.assert_array_equal(port["seed"], [3] * 6 + [4] * 6)
    cells = sweep.grid_cells([0], cfg=GAConfig(**cfg_kw))
    assert (cells["baseline_acc"] == np.float32(1.0)).all()


def test_grid_refuses_a_device_mesh(bc_dataset):
    ds = bc_dataset
    problem = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                       GAConfig(pop_size=8, generations=1), device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        sweep.run_grid(problem, [0], mesh=object())
    doped = sweep.run_grid(dataclasses.replace(problem), [0], generations=0,
                           doping_seeds=[np.zeros(problem.spec.n_genes, np.int32)])
    assert (doped.state_at(0).pop == 0).all(dim=1).any()
