"""The port's suite batching (``sweep.run_suite``: datasets of several
topologies and sample counts embedded into one padded layout, every
(dataset × seed × config) cell a lane of one batched run) against the
reference's ``run_suite`` and against the port's unpadded sequential
``GATrainer.run`` per cell, bit for bit (``tests/test_suite.py``): dedup on
and off, doping with a config axis, the device-variation mode; padded
genes never perturbed; padded counts and areas equal the inner problem's;
the padding helpers and the sample buckets equal the reference's."""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from repro.core import GAConfig as JCfg, engine as jeng, sweep as jsweep
from repro.core import genome as jg
from repro.core.genome import MLPTopology as JTopo
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine, prng, sweep
from repro_torch.core import genome as tg
from repro_torch.core.interop import state_to_numpy
from repro_torch.data import load_dataset
from test_torch_interop import assert_bits_equal, assert_states_equal

SEEDS = (0, 1)
RUN = dict(pop_size=16, generations=4)


@pytest.fixture(scope="module")
def two_datasets():
    # different feature counts, hidden widths, class counts, sample counts
    return load_dataset("breast_cancer"), load_dataset("redwine")


def _problems(datasets, cfg):
    return [engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg,
                                     device="cpu") for ds in datasets]


def _trainer(ds, cfg, seed, **kw):
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                   dataclasses.replace(cfg, seed=seed), device="cpu", **kw)
    return tr, tr.run()[0]


def assert_cell_equals_trainer(result, i, tr, state, dedup=True):
    """A suite cell (population gathered back to its unpadded layout) ==
    the sequential trainer: every field but the cache (whose rows are in
    the padded layout), the dedup accounting and the front."""
    a = state_to_numpy(dataclasses.replace(result.state_at(i), cache=None))
    b = state_to_numpy(dataclasses.replace(state, cache=None))
    for name in a:
        assert_bits_equal(b[name], a[name], f"cell {result.cell(i)}: {name}")
    if dedup:
        assert result.unique_evals(i) == tr.unique_evals, result.cell(i)
        assert result.cache_hits(i) == tr.cache_hits, result.cell(i)
    f_tr, f_suite = tr.front(state), result.front_at(i)
    for k in ("objectives", "genomes"):
        assert_bits_equal(f_tr[k], f_suite[k], f"front {k}")


@pytest.fixture(scope="module")
def suites(two_datasets):
    """The reference's suite and the port's, dedup on (one reference
    compile per module)."""
    names = [ds.name for ds in two_datasets]
    jprobs = [jeng.Problem.from_data(JTopo(ds.topology), ds.x_train, ds.y_train,
                                     JCfg(**RUN)) for ds in two_datasets]
    ref = jsweep.run_suite(jprobs, SEEDS, names=names)
    port = sweep.run_suite(_problems(two_datasets, GAConfig(**RUN)), SEEDS, names=names)
    return ref, port


def test_suite_matches_reference(suites):
    ref, port = suites
    assert port.shape == ref.shape == (2, len(SEEDS), 1, 1, 1, 1)
    assert port.spec.topo == tg.MLPTopology(ref.spec.topo.sizes)
    for i in range(port.n_cells):
        assert port.cell(i) == ref.cell(i)
        assert_states_equal(ref.state_at(i, unpad=False), port.state_at(i, unpad=False),
                            msg=f"cell {port.cell(i)}")          # padded caches too
        assert_states_equal(ref.state_at(i), port.state_at(i), msg=f"unpadded cell {i}",
                            cache=False)
        assert (port.unique_evals(i), port.cache_hits(i)) == (ref.unique_evals(i),
                                                               ref.cache_hits(i))
    for k in range(4):
        assert_bits_equal(ref.aux[k], port.aux[k], f"aux[{k}]")
    assert_bits_equal(ref.init_evals, port.init_evals, "init evals")
    assert port.cells_of("redwine") == ref.cells_of("redwine")


@pytest.mark.parametrize("dedup", [True, False])
def test_suite_matches_unpadded_trainers(two_datasets, suites, dedup):
    cfg = GAConfig(**RUN, dedup=dedup)
    result = (suites[1] if dedup else
              sweep.run_suite(_problems(two_datasets, cfg), SEEDS,
                              names=[ds.name for ds in two_datasets]))
    for i in range(result.n_cells):
        ds = two_datasets[result.dataset_of(i)]
        tr, state = _trainer(ds, cfg, result.cell(i)["seed"])
        assert_cell_equals_trainer(result, i, tr, state, dedup)


def test_suite_with_doping_and_config_axis(two_datasets):
    """Doping genomes from the reference's ``calibrated_seeds`` (as numpy,
    unpadded) compose with a mutation-rate axis; sample buckets split the
    run and change no cell."""
    from repro.core import calibrated_seeds
    from repro.core.baselines import train_float_mlp

    cfg = GAConfig(pop_size=16, generations=3)
    rates = (0.02, 0.05)
    doping = []
    for ds in two_datasets:
        topo = JTopo(ds.topology)
        fm = train_float_mlp(topo, ds.x_train, ds.y_train, ds.x_test, ds.y_test, steps=200)
        doping.append([np.asarray(s) for s in calibrated_seeds(jg.GenomeSpec(topo), fm,
                                                               ds.x_train)])
    kw = dict(mutation_rates=rates, doping_seeds=doping,
              names=[ds.name for ds in two_datasets])
    result = sweep.run_suite(_problems(two_datasets, cfg), [0], **kw)
    assert result.shape == (2, 1, 1, len(rates), 1, 1)
    for i in range(result.n_cells):
        d = result.dataset_of(i)
        c = dataclasses.replace(cfg, mutation_rate_gene=result.cell(i)["mutation_rate_gene"])
        tr, state = _trainer(two_datasets[d], c, 0, doping_seeds=doping[d])
        assert_cell_equals_trainer(result, i, tr, state)
    bucketed = sweep.run_suite(_problems(two_datasets, cfg), [0], sample_bucket_factor=1.0,
                               **kw)
    for name in ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen"):
        assert torch.equal(getattr(result.states, name), getattr(bucketed.states, name))
    assert torch.equal(result.states.cache.rows, bucketed.states.cache.rows)


def test_suite_mc_matches_unpadded_trainers(two_datasets):
    cfg = GAConfig(pop_size=16, generations=3, variation_mode="worst", n_device_samples=3)
    result = sweep.run_suite(_problems(two_datasets, cfg), [4])
    assert result.states.counts.shape == (2, 16, 3)
    for i in range(result.n_cells):
        tr, state = _trainer(two_datasets[result.dataset_of(i)], cfg, 4)
        assert_cell_equals_trainer(result, i, tr, state)


def _spec_pad(bc, rw):
    return tg.GenomeSpec(tg.max_topology([MLPTopology(bc.topology),
                                          MLPTopology(rw.topology)]))


def test_padding_helpers_match_reference(two_datasets):
    bc, rw = two_datasets
    topos = [JTopo(bc.topology), JTopo(rw.topology)]
    j_pad = jg.GenomeSpec(jg.max_topology(topos))
    t_pad = _spec_pad(bc, rw)
    assert t_pad.topo.sizes == j_pad.topo.sizes
    for ds in (bc, rw):
        j_in, t_in = jg.GenomeSpec(JTopo(ds.topology)), tg.GenomeSpec(MLPTopology(ds.topology))
        pos = tg.pad_positions(t_in, t_pad)
        np.testing.assert_array_equal(pos, jg.pad_positions(j_in, j_pad))
        jt, tt = jg.padded_table(j_in, j_pad), tg.padded_table(t_in, t_pad, pos)
        for f in ("low", "high", "is_mask", "mask_bits", "ids", "valid"):
            assert_bits_equal(getattr(jt, f), getattr(tt, f), f)
        g = np.random.default_rng(0).integers(0, 9, (3, t_in.n_genes))
        np.testing.assert_array_equal(tg.pad_genomes(g, pos, t_pad.n_genes),
                                      jg.pad_genomes(g, pos, j_pad.n_genes))
    with pytest.raises(ValueError, match="layer count"):
        tg.max_topology([MLPTopology((4, 3, 2)), MLPTopology((4, 2))])


def test_operators_never_perturb_padded_genes(two_datasets):
    from repro_torch.core.operators import make_offspring

    bc, rw = two_datasets
    inner = tg.GenomeSpec(MLPTopology(bc.topology))
    spec_pad = _spec_pad(bc, rw)
    table = tg.padded_table(inner, spec_pad)
    pop = tg.random_population(prng.PRNGKey(0), table, 32)
    invalid = ~table.valid
    assert int(pop[:, invalid].abs().sum()) == 0, "init wrote into padding"
    children = make_offspring(prng.PRNGKey(1), pop, torch.zeros(32, dtype=torch.int32),
                              torch.ones(32), table, torch.tensor(0.9), torch.tensor(0.5))
    assert int(children[:, invalid].abs().sum()) == 0, "variation wrote into padding"
    problem = engine.pad_problem(_problems([bc], GAConfig(pop_size=16, generations=3))[0],
                                 spec_pad)
    state, _ = engine.init_state(problem, prng.PRNGKey(0))
    state, _ = engine.run_scanned(problem, state, 3)
    assert int(state.pop[:, invalid].abs().sum()) == 0


@pytest.mark.parametrize("backend", ["ref", "kernel", "jnp"])
def test_padded_fitness_counts_match_inner(two_datasets, backend, monkeypatch):
    """Padded fan-in/fan-out, output mask and samples give the inner counts
    on every backend (the kernel's through its plain version), and the
    reference's padded counts."""
    from repro.kernels.pop_mlp import population_correct as j_correct
    from repro_torch.kernels.pop_mlp import population_correct
    from test_torch_interop import kernel_paths_on_cpu

    kernel_paths_on_cpu(monkeypatch)
    bc, rw = two_datasets
    inner = tg.GenomeSpec(MLPTopology(bc.topology))
    spec_pad = _spec_pad(bc, rw)
    pos = tg.pad_positions(inner, spec_pad)
    pop = tg.random_population(prng.PRNGKey(3), inner.table(), 12)
    p_in = _problems([bc], GAConfig(pop_size=12))[0]
    p_pad = engine.pad_problem(p_in, spec_pad, n_samples=p_in.x_int.shape[0] + 57)
    want = population_correct(pop, p_in.x_int, p_in.labels, spec=inner, backend=backend)
    pop_pad = torch.as_tensor(tg.pad_genomes(pop.numpy(), pos, spec_pad.n_genes))
    for n_samp in (None, p_pad.n_valid_samples):
        got = population_correct(pop_pad, p_pad.x_int, p_pad.labels, spec=spec_pad,
                                 backend=backend, out_mask=p_pad.out_mask,
                                 n_valid_samples=n_samp)
        assert torch.equal(got, want), n_samp
    j_pad = jg.GenomeSpec(JTopo(spec_pad.topo.sizes))
    ref = j_correct(jax.numpy.asarray(pop_pad.numpy()), jax.numpy.asarray(p_pad.x_int.numpy()),
                    jax.numpy.asarray(p_pad.labels.numpy()), spec=j_pad, backend="ref",
                    out_mask=jax.numpy.asarray(p_pad.out_mask.numpy()))
    assert_bits_equal(ref, want, "reference padded counts")


def test_padded_area_matches_inner(two_datasets):
    from repro_torch.core.area import population_area

    bc, rw = two_datasets
    inner = tg.GenomeSpec(MLPTopology(bc.topology))
    spec_pad = _spec_pad(bc, rw)
    pop = tg.random_population(prng.PRNGKey(4), inner.table(), 8)
    pop_pad = torch.as_tensor(tg.pad_genomes(pop.numpy(), tg.pad_positions(inner, spec_pad),
                                             spec_pad.n_genes))
    assert torch.equal(population_area(spec_pad, pop_pad), population_area(inner, pop))


def test_suite_rejects_mismatched_configs_and_a_mesh(two_datasets):
    bc, rw = two_datasets
    p1 = _problems([bc], GAConfig(pop_size=8))[0]
    p2 = _problems([rw], GAConfig(pop_size=16))[0]
    with pytest.raises(ValueError, match="share one GAConfig"):
        sweep.run_suite([p1, p2], [0])
    with pytest.raises(NotImplementedError, match="A13"):
        sweep.run_suite([p1], [0], mesh=object())
    with pytest.raises(ValueError, match="align"):
        sweep.run_suite([p1], [0], doping_seeds=[[], []])


def test_pad_problem_rejects_jnp_backend(two_datasets):
    from repro_torch.kernels.backend import BackendPolicy

    bc, rw = two_datasets
    p = _problems([bc], GAConfig(pop_size=8, backends=BackendPolicy(fitness="jnp")))[0]
    with pytest.raises(ValueError, match="count-based"):
        engine.pad_problem(p, _spec_pad(bc, rw))
    with pytest.raises(ValueError, match="n_samples"):
        engine.pad_problem(_problems([bc], GAConfig(pop_size=8))[0], _spec_pad(bc, rw),
                           n_samples=3)


@pytest.mark.parametrize("sizes", [[455, 1119, 1488, 3897, 7494], [100, 100, 60, 200, 99],
                                   [5], [10, 20, 15, 40, 39, 80]])
@pytest.mark.parametrize("factor", [None, 1.0, 1.5, 2.0, 4.0])
def test_sample_buckets_match_reference(sizes, factor):
    got = sweep._sample_buckets(sizes, factor)
    assert got == jsweep._sample_buckets(sizes, factor)
    assert sorted(d for b in got for d in b) == list(range(len(sizes)))
