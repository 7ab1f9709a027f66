"""One generation of the port started from the reference's own state
(carried over with ``interop.state_from_numpy``), and one of the reference
started from the port's: every generation backend × dedup mode gives the
reference's next state, EvalCache and accounting, bit for bit.

The reference runs under ``jax.jit``, as its trainer does: there XLA fuses
the accuracy product into the objective subtractions (one rounding), which
the port reproduces; the reference's eager path rounds twice and differs
from its own jitted path by an ulp in ``obj``/``viol``."""
import numpy as np
import pytest
import jax
import torch

from repro.core import GAConfig as JCfg, engine as jeng
from repro.core.genome import MLPTopology as JTopo
from repro.kernels.pop_generation import population_generation as j_gen
from repro_torch.core import GAConfig, MLPTopology, engine, prng
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels.pop_generation import population_generation
from test_torch_interop import (assert_bits_equal, assert_states_equal,
                                jax_leaves, jax_state, kernel_paths_on_cpu)

# port backend → the reference backend it is held against
BACKENDS = {"ref": "ref", "phases": "phases", "kernel": "interpret"}

_j_init = jax.jit(jeng.init_state)
_j_gen = jax.jit(j_gen, static_argnames="backend")


def _problems(ds, dedup):
    kw = dict(pop_size=16, seed=4, dedup=dedup)
    jp = jeng.Problem.from_data(JTopo(ds.topology), ds.x_train, ds.y_train,
                                JCfg(fitness_backend="ref", **kw))
    tp = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train,
                                  ds.y_train, GAConfig(**kw), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def problems(bc_dataset):
    """(reference problem, port problem, reference init state) per dedup
    mode, built once so the reference compiles once per mode."""
    out = {}
    for dedup in (False, "legacy", True):
        jp, tp = _problems(bc_dataset, dedup)
        out[dedup] = (jp, tp, _j_init(jp, jax.random.PRNGKey(3))[0])
    return out


@pytest.mark.parametrize("backend,dedup", [("ref", True), ("phases", True),
                                           ("kernel", True), ("kernel", "legacy"),
                                           ("kernel", False), ("phases", False)])
def test_one_generation_from_the_reference_state(problems, backend, dedup,
                                                 monkeypatch):
    kernel_paths_on_cpu(monkeypatch)
    jp, tp, j0 = problems[dedup]
    t0 = state_from_numpy(jax_leaves(j0), device="cpu")
    j1, jaux = _j_gen(jp, j0, backend=BACKENDS[backend])
    t1, taux = population_generation(tp, t0, backend=backend)
    assert_states_equal(j1, t1, msg=f"{backend}/{dedup}")
    for k, (a, b) in enumerate(zip(jaux, taux)):
        assert_bits_equal(a, b, f"aux[{k}]")


def test_reference_continues_from_the_port_state(problems):
    """The port's init state, carried back, drives the reference's next
    generation to the same state the port reaches."""
    jp, tp, _ = problems[True]
    t0, n0 = engine.init_state(tp, prng.PRNGKey(8))
    j0, jn0 = _j_init(jp, jax.random.PRNGKey(8))
    assert_states_equal(j0, t0, msg="init")
    assert int(n0) == int(jn0)
    j1, _ = _j_gen(jp, jax_state(state_to_numpy(t0)), backend="ref")
    t1, _ = population_generation(tp, t0, backend="ref")
    assert_states_equal(j1, t1, msg="continued")


def test_swept_hypers_match_reference(problems):
    """``Problem.with_hypers`` (Python floats become () float32 tensors)
    under a tight feasibility bound, so violations are live: init and one
    generation equal the reference's swept problem."""
    jp, tp, _ = problems[True]
    hy = dict(crossover_rate=0.55, mutation_rate_gene=0.3, max_acc_loss=0.02,
              baseline_acc=0.97)
    jp2 = jp.with_hypers(**{k: jax.numpy.float32(v) for k, v in hy.items()})
    tp2 = tp.with_hypers(**hy)
    assert all(getattr(tp2, k).dtype == torch.float32 for k in hy)
    j0, _ = _j_init(jp2, jax.random.PRNGKey(6))
    t0, _ = engine.init_state(tp2, prng.PRNGKey(6))
    assert_states_equal(j0, t0, msg="swept init")
    assert (t0.viol > 0).any()
    j1, _ = _j_gen(jp2, j0, backend="ref")
    t1, _ = population_generation(tp2, t0, backend="ref")
    assert_states_equal(j1, t1, msg="swept generation")


def test_doped_init_matches_reference(problems, bc_dataset):
    ds = bc_dataset
    spec = engine.GenomeSpec(MLPTopology(ds.topology))
    rng = np.random.default_rng(0)
    seeds = rng.integers(spec.low, spec.high, (3, spec.n_genes)).astype(np.int32)
    jp, tp, _ = problems["legacy"]
    j0, jn = _j_init(jp, jax.random.PRNGKey(1), jax.numpy.asarray(seeds))
    t0, tn = engine.init_state(tp, prng.PRNGKey(1), list(seeds))
    assert_states_equal(j0, t0, msg="doped init")
    assert int(jn) == int(tn)
    assert torch.equal(t0.pop[0], torch.as_tensor(seeds[0]))
