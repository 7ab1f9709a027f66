"""The port's ``GATrainer.run`` against the reference's, end to end: every
generation backend (the kernel path through its kernels' plain versions,
"ref", "phases") × dedup mode (off, "legacy", cache) gives the reference's
final state (EvalCache and key included), Pareto front, ``unique_evals``
and ``cache_hits``, bit for bit; and the port's runs are equal across
dedup modes, as the reference's are."""
import numpy as np
import pytest
import torch

from repro.core import GAConfig as JCfg, GATrainer as JTrainer
from repro.core.genome import GenomeSpec as JSpec, MLPTopology as JTopo
from repro_torch.core import GAConfig, GATrainer, MLPTopology
from repro_torch.core.interop import state_to_numpy
from repro_torch.kernels.backend import BackendPolicy
from test_torch_interop import (NO_COUNTS, assert_bits_equal, assert_states_equal,
                                kernel_paths_on_cpu)

# port generation backend → the reference backend it is held against
BACKENDS = {"kernel": "interpret", "ref": "ref", "phases": "phases"}
DEDUPS = (False, "legacy", True)
RUN = dict(pop_size=16, generations=3, seed=2)

_ref_runs: dict = {}


def _ref_run(ds, backend, dedup):
    """The reference run (cached: each is compiled and run once)."""
    if (backend, dedup) not in _ref_runs:
        interp = BACKENDS[backend] == "interpret"
        cfg = JCfg(**RUN, dedup=dedup, fitness_backend="interpret" if interp else "ref",
                   variation_backend="interpret" if interp else "ref",
                   generation_backend=BACKENDS[backend])
        tr = JTrainer(JTopo(ds.topology), ds.x_train, ds.y_train, cfg)
        state, _ = tr.run()
        _ref_runs[backend, dedup] = (state, tr)
    return _ref_runs[backend, dedup]


def _port_run(ds, backend, dedup, **kw):
    cfg = GAConfig(**RUN, dedup=dedup, backends=BackendPolicy(generation=backend))
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg,
                   device="cpu", **kw)
    state, history = tr.run(verbose=True)
    assert [h["gen"] for h in history] == [0, RUN["generations"] - 1]
    return state, tr


@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_trainer_run_matches_reference(bc_dataset, backend, dedup, monkeypatch):
    kernel_paths_on_cpu(monkeypatch)
    js, jt = _ref_run(bc_dataset, backend, dedup)
    ts, tt = _port_run(bc_dataset, backend, dedup)
    assert_states_equal(js, ts, msg=f"{backend}/{dedup}")
    assert (tt.unique_evals, tt.cache_hits) == (jt.unique_evals, jt.cache_hits)
    jf, tf = jt.front(js), tt.front(ts)
    for k in ("objectives", "indices", "genomes"):
        assert_bits_equal(jf[k], tf[k], f"front {k}")


def test_trainer_run_matches_reference_on_cardio():
    """A second dataset: 21 inputs, 3 classes, 1488 training rows."""
    from repro_torch.data import load_dataset

    ds = load_dataset("cardio")
    jt = JTrainer(JTopo(ds.topology), ds.x_train, ds.y_train, JCfg(**RUN))
    js, _ = jt.run()
    ts, tt = _port_run(ds, "auto", True)
    assert_states_equal(js, ts, msg="cardio")
    assert (tt.unique_evals, tt.cache_hits) == (jt.unique_evals, jt.cache_hits)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_trainer_dedup_modes_agree(bc_dataset, backend, monkeypatch):
    """Dedup off / legacy / cache give identical states (counts are zero
    with dedup off by design) and fronts."""
    kernel_paths_on_cpu(monkeypatch)
    runs = {d: _port_run(bc_dataset, backend, d) for d in DEDUPS}
    a = {d: state_to_numpy(s) for d, (s, _) in runs.items()}
    for name in NO_COUNTS:
        assert_bits_equal(a[False][name], a["legacy"][name], f"off/legacy {name}")
        assert_bits_equal(a["legacy"][name], a[True][name], f"legacy/cache {name}")
    assert_bits_equal(a["legacy"]["counts"], a[True]["counts"], "counts")
    assert runs[True][0].cache is not None and runs[False][0].cache is None
    if backend == "ref":   # only the cache backend can save evaluations
        u = {d: tr.unique_evals for d, (_, tr) in runs.items()}
        assert u[True] == u["legacy"] - runs[True][1].cache_hits


def test_scan_false_keeps_accounting_none_and_the_same_state(bc_dataset):
    cfg = GAConfig(**RUN)
    tr = GATrainer(MLPTopology(bc_dataset.topology), bc_dataset.x_train,
                   bc_dataset.y_train, cfg, device="cpu")
    s_loop, hist = tr.run(scan=False, verbose=True)
    assert tr.unique_evals is None and tr.cache_hits is None
    assert [h["gen"] for h in hist] == [0, 2]
    s_scan, _ = tr.run()
    assert tr.unique_evals is not None
    a, b = state_to_numpy(s_loop), state_to_numpy(s_scan)
    for name in ("pop", "obj", "viol", "key", "gen"):
        assert_bits_equal(a[name], b[name], name)


def test_doped_jnp_fitness_run_matches_reference(bc_dataset):
    """Doping seeds, a baseline, and the untiled 'jnp' fitness oracle
    (dedup forced off), whose accuracy is a mean over the samples."""
    ds = bc_dataset
    spec = JSpec(JTopo(ds.topology))
    rng = np.random.default_rng(1)
    seeds = list(rng.integers(np.asarray(spec.low), np.asarray(spec.high),
                              (2, spec.n_genes)).astype(np.int32))
    jt = JTrainer(JTopo(ds.topology), ds.x_train, ds.y_train,
                  JCfg(**RUN, fitness_backend="jnp", doping_frac=0.25),
                  baseline_acc=0.9, doping_seeds=seeds)
    js, _ = jt.run()
    tt = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                   GAConfig(**RUN, backends=BackendPolicy(fitness="jnp"),
                            doping_frac=0.25),
                   baseline_acc=0.9, doping_seeds=seeds, device="cpu")
    ts, _ = tt.run()
    assert_states_equal(js, ts, msg="jnp doped")
    assert tt.unique_evals == jt.unique_evals
    assert torch.equal(tt.x_int, torch.as_tensor(np.asarray(jt.x_int)))
