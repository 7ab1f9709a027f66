"""The port's whole-run batching (``engine.run_batch``: L seeds as the
lanes of one batched run) against the reference's ``run_batch`` (its
``vmap`` over seeds) and against the port's own sequential runs, bit for
bit: every GAState field, the EvalCache included, the per-generation aux
and the initial evaluation counts, dedup on and off, with doping and in
the device-variation (MC) mode (``tests/test_engine.py``'s ``run_batch``
cases). The lane helpers and the lane-axis plain versions of the kernels
are held against per-lane calls, and a batched generation calls each
kernel wrapper once for all lanes."""
import numpy as np
import pytest
import torch

from repro.core import GAConfig as JCfg, engine as jeng
from repro.core.genome import MLPTopology as JTopo
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine, prng
from repro_torch.core.genome import _slot_keys, random_population
from repro_torch.core.interop import state_to_numpy
from repro_torch.kernels.backend import BackendPolicy
from test_torch_interop import (assert_bits_equal, assert_states_equal,
                                kernel_paths_on_cpu)

SEEDS = (0, 1, 2)
RUN = dict(pop_size=16, generations=3)
MC = dict(variation_mode="mean", n_device_samples=4)

_ref: dict = {}


def _ref_batch(ds, name, seeds, doping=None, **kw):
    """The reference's run_batch (cached per process: each compiles once)."""
    if name not in _ref:
        p = jeng.Problem.from_data(JTopo(ds.topology), ds.x_train, ds.y_train,
                                   JCfg(**RUN, **kw))
        _ref[name] = jeng.run_batch(p, list(seeds), doping_seeds=doping)
    return _ref[name]


def _port_problem(ds, **kw):
    return engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                    GAConfig(**RUN, **kw), device="cpu")


def assert_batch_equal(ref, port, seeds, msg):
    (js, jaux, jn0), (ts, taux, tn0) = ref, port
    for i, s in enumerate(seeds):
        assert_states_equal(jeng.state_at(js, i), engine.state_at(ts, i),
                            msg=f"{msg} seed {s}")
    for k in range(4):
        assert_bits_equal(jaux[k], taux[k], f"{msg} aux[{k}]")
    assert_bits_equal(jn0, tn0, f"{msg} init evals")


def assert_sequential(problem, batch, seeds, doping=None, msg=""):
    """Each lane equals its own init_state + run_scanned."""
    states, aux, n0 = batch
    for i, s in enumerate(seeds):
        st, m = engine.init_state(problem, prng.PRNGKey(s), doping)
        st, a = engine.run_scanned(problem, st, problem.cfg.generations)
        assert_states_equal_port(engine.state_at(states, i), st, f"{msg} seed {s}")
        for k in range(4):
            assert torch.equal(aux[k][i], a[k]), (msg, s, k)
        assert int(n0[i]) == int(m)


def assert_states_equal_port(a, b, msg):
    la, lb = state_to_numpy(a), state_to_numpy(b)
    assert set(la) == set(lb), msg
    for name in la:
        assert_bits_equal(la[name], lb[name], f"{msg}: {name}")


@pytest.mark.parametrize("dedup", [True, False])
def test_run_batch_matches_reference_and_seed_loop(bc_dataset, dedup):
    problem = _port_problem(bc_dataset, dedup=dedup)
    port = engine.run_batch(problem, SEEDS)
    assert port[0].pop.shape == (3, 16, problem.spec.n_genes)
    assert all(a.shape == (3, RUN["generations"]) for a in port[1])
    assert_batch_equal(_ref_batch(bc_dataset, f"dedup={dedup}", SEEDS, dedup=dedup),
                       port, SEEDS, f"dedup={dedup}")
    assert_sequential(problem, port, SEEDS, msg=f"dedup={dedup}")


def test_run_batch_matches_trainers_unique_evals_and_hits(bc_dataset):
    problem = _port_problem(bc_dataset)
    states, aux, n0 = engine.run_batch(problem, SEEDS)
    for i, s in enumerate(SEEDS):
        tr = GATrainer(MLPTopology(bc_dataset.topology), bc_dataset.x_train,
                       bc_dataset.y_train, GAConfig(**RUN, seed=s), device="cpu")
        st, _ = tr.run()
        assert_states_equal_port(engine.state_at(states, i), st, f"seed {s}")
        assert int(n0[i]) + int(aux[2][i].sum()) == tr.unique_evals
        assert int(aux[3][i].sum()) == tr.cache_hits


def test_run_batch_with_doping_matches_reference(bc_dataset, bc_float, bc_spec):
    """Doping genomes from the reference's ``calibrated_seeds`` (as numpy)
    broadcast over the batch."""
    from repro.core import calibrated_seeds

    doping = np.stack([np.asarray(s) for s in
                       calibrated_seeds(bc_spec, bc_float, bc_dataset.x_train)])
    problem = _port_problem(bc_dataset)
    port = engine.run_batch(problem, [0, 1], doping_seeds=doping)
    assert_batch_equal(_ref_batch(bc_dataset, "doped", [0, 1], doping=list(doping)),
                       port, [0, 1], "doped")
    assert_sequential(problem, port, [0, 1], doping=torch.as_tensor(doping), msg="doped")


def test_run_batch_mc_matches_reference(bc_dataset):
    problem = _port_problem(bc_dataset, **MC)
    port = engine.run_batch(problem, [0, 1])
    assert port[0].counts.shape == (2, 16, 4) and port[0].obj.shape == (2, 16, 3)
    assert port[0].cache.vals.shape[-1] == 4
    assert_batch_equal(_ref_batch(bc_dataset, "mc", [0, 1], **MC), port, [0, 1], "mc")
    assert_sequential(problem, port, [0, 1], msg="mc")


@pytest.mark.parametrize("backend", ["kernel", "ref", "phases"])
def test_run_batch_backends_agree(bc_dataset, backend, monkeypatch):
    """Every generation backend gives the same batched states (the kernel
    path through the kernels' plain versions)."""
    kernel_paths_on_cpu(monkeypatch)
    pol = BackendPolicy(fitness="kernel" if backend == "kernel" else "ref",
                        variation="kernel" if backend == "kernel" else "ref",
                        generation=backend)
    states, _, _ = engine.run_batch(_port_problem(bc_dataset, backends=pol), [0, 3])
    base, _, _ = engine.run_batch(_port_problem(bc_dataset), [0, 3])
    fields = ("pop", "obj", "viol", "rank", "crowd", "key", "gen")
    for i in range(2):
        a, b = state_to_numpy(engine.state_at(states, i)), state_to_numpy(
            engine.state_at(base, i))
        for f in fields:
            assert_bits_equal(a[f], b[f], f"{backend} lane {i}: {f}")


def test_run_batch_seeds_are_independent(bc_dataset):
    states, _, _ = engine.run_batch(_port_problem(bc_dataset), [0, 7])
    assert not torch.equal(states.pop[0], states.pop[1])


def test_lanes_stack_and_peel(bc_dataset):
    """``stack_problems`` → ``lane``; ``stack_states`` → ``state_at``; a
    tagged unstacked problem refuses to run, mismatched lanes to stack."""
    p = _port_problem(bc_dataset)
    q = p.with_hypers(mutation_rate_gene=0.05)
    b = engine.stack_problems([engine.batch_problem(p), q])
    assert b.n_lanes == 2 and b.cfg.batch_axis == engine.BATCH_AXIS
    assert p.n_lanes is None and b.lane(1).cfg.batch_axis is None
    assert float(b.lane(1).mutation_rate_gene) == np.float32(0.05)
    assert torch.equal(b.lane(0).x_int, p.x_int)
    st, _ = engine.init_state(p, prng.PRNGKey(4))
    both = engine.stack_states([st, st])
    assert_states_equal_port(engine.state_at(both, 1), st, "peel")
    with pytest.raises(ValueError, match="stacked"):
        engine.init_state(engine.batch_problem(p), prng.PRNGKey(0))
    with pytest.raises(ValueError, match="GAConfig"):
        engine.stack_problems([p, p.replace_cfg(pop_size=8)])
    with pytest.raises(ValueError, match="single"):
        engine.run_batch(b, [0])


def test_batched_generation_calls_each_kernel_once_for_all_lanes(bc_dataset, monkeypatch):
    """One generation of a 3-lane problem calls the generation kernel's
    wrapper once (the megakernel path), and the variation and fitness
    wrappers once each (the per-phase path)."""
    from repro_torch.kernels.pop_generation import ops as gen_ops
    from repro_torch.kernels.pop_mlp import ops as mlp_ops
    from repro_torch.kernels.pop_variation import ops as var_ops

    kernel_paths_on_cpu(monkeypatch)
    calls = []

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls.append((name, a[0].shape))
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    counted(gen_ops, "pop_generation_kernel")
    counted(var_ops, "pop_variation_kernel")
    counted(mlp_ops, "pop_mlp_correct")
    for gen_backend, want in (("kernel", ["pop_generation_kernel"]),
                              ("phases", ["pop_variation_kernel", "pop_mlp_correct"])):
        pol = BackendPolicy(fitness="kernel", variation="kernel", generation=gen_backend)
        p = _port_problem(bc_dataset, backends=pol)
        b = engine.stack_problems([engine.batch_problem(p)] * 3)
        states, _ = engine.init_state(b, torch.stack([prng.PRNGKey(s) for s in (0, 1, 2)]))
        calls.clear()
        engine.generation(b, states)
        assert [c[0] for c in calls] == want, gen_backend
        assert all(c[1][0] == 3 for c in calls)          # (L, ...) operands


def _lane_case(spec, rng, L, P, S):
    """L lanes of one layout: own genomes, samples, labels (−1 padding past
    each lane's own count), output masks and delta tables."""
    t = spec.table("cpu")
    pop = torch.stack([random_population(prng.PRNGKey(int(rng.integers(1e6))), t, P)
                       for _ in range(L)])
    n_in, n_out = spec.topo.sizes[0], spec.topo.sizes[-1]
    x = torch.as_tensor(rng.integers(0, 16, (L, S, n_in)), dtype=torch.int32)
    y = torch.as_tensor(rng.integers(0, n_out, (L, S)), dtype=torch.int32)
    n_samp = torch.as_tensor(rng.integers(S // 3, S + 1, L), dtype=torch.int32)
    for i in range(L):
        y[i, int(n_samp[i]):] = -1
    om = torch.ones((L, n_out), dtype=torch.int32)
    om[:, -1] = torch.as_tensor(rng.integers(0, 2, L), dtype=torch.int32)
    dev = torch.as_tensor(rng.integers(-1, 2, (L, 3, spec.n_genes)), dtype=torch.int32)
    dev = torch.where(torch.as_tensor(spec.is_exp), dev, 0)
    dev[:, 0] = 0
    return t, pop, x, y, n_samp, om, dev


@pytest.mark.parametrize("L", [1, 3])
def test_lane_axis_plain_versions_equal_per_lane_calls(L):
    """The lane-axis form of each kernel's plain version (what a CPU tensor
    runs) equals L single-problem calls, with unequal per-lane sample
    counts and a shared row bound below P."""
    from repro_torch.core.genome import GenomeSpec
    from repro_torch.kernels.pop_generation import pop_generation_kernel
    from repro_torch.kernels.pop_mlp import pop_mlp_correct, pop_mlp_correct_mc
    from repro_torch.kernels.pop_variation import pop_variation_kernel

    rng = np.random.default_rng(L)
    spec = GenomeSpec(MLPTopology((6, 4, 3)))
    t, pop, x, y, n_samp, om, dev = _lane_case(spec, rng, L, 12, 40)
    rows = torch.tensor(7, dtype=torch.int32)
    hi = t.high.expand(L, -1)
    got = pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=rows, n_valid_samples=n_samp,
                          out_mask=om)
    got_mc = pop_mlp_correct_mc(pop, x, y, dev, hi, spec=spec, n_valid_rows=rows,
                                n_valid_samples=n_samp, out_mask=om)
    tables = [a.expand(L, -1) for a in (t.low, t.high, t.is_mask, t.mask_bits, t.ids)]
    keys = torch.stack([_slot_keys(prng.PRNGKey(int(rng.integers(1e6))), (0, 1, 2))
                        for _ in range(L)])
    do = torch.as_tensor(rng.random((L, 12)) < 0.7)
    pm = torch.as_tensor(rng.random(L) * 0.3, dtype=torch.float32)
    var = (pop, pop.flip(1), do, *tables, keys, pm)
    children = pop_variation_kernel(*var)
    ch_g, cnt_g = pop_generation_kernel(*var, x, y, spec=spec, n_valid_samples=n_samp,
                                        out_mask=om)
    ch_m, cnt_m = pop_generation_kernel(*var, x, y, spec=spec, n_valid_samples=n_samp,
                                        out_mask=om, dev=dev)
    for i in range(L):
        kw = dict(spec=spec, n_valid_samples=n_samp[i], out_mask=om[i])
        one = pop_mlp_correct(pop[i], x[i], y[i], n_valid_rows=rows, **kw)
        assert torch.equal(got[i], one) and (got[i, 7:] == 0).all()
        assert torch.equal(got_mc[i], pop_mlp_correct_mc(pop[i], x[i], y[i], dev[i], t.high,
                                                         n_valid_rows=rows, **kw))
        assert torch.equal(got_mc[i, :, 0], one)
        one_var = tuple(a[i] for a in var)
        assert torch.equal(children[i], pop_variation_kernel(*one_var))
        c1, n1 = pop_generation_kernel(*one_var, x[i], y[i], **kw)
        assert torch.equal(ch_g[i], c1) and torch.equal(cnt_g[i], n1)
        assert torch.equal(ch_m[i], c1)
        assert torch.equal(cnt_m[i], pop_generation_kernel(*one_var, x[i], y[i],
                                                           dev=dev[i], **kw)[1])
