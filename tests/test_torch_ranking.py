"""The port's NSGA-II ranking against the reference: the sweep and the
matrix oracle on the edge-case pools of tests/test_ranking_path.py
(duplicates, ties, all-infeasible, P = 1, mixed), the whole (μ+λ) tail,
the 3-objective fold and tournament selection; tolerance 0."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import nsga2 as jn
from repro.kernels import pop_ranking as jr
from repro.kernels.pop_ranking import ops as jr_ops
from repro_torch.core import nsga2 as tn, prng
from repro_torch.kernels import pop_ranking as tr
from test_ranking_path import EDGE_CASES
from test_torch_interop import assert_bits_equal


def _both(obj, viol):
    return ((jnp.asarray(obj), jnp.asarray(viol)),
            (torch.as_tensor(obj), torch.as_tensor(viol)))


@pytest.mark.parametrize("backend", ["sweep", "matrix"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_ranking_edge_cases(case, backend):
    (oj, vj), (ot, vt) = _both(*EDGE_CASES[case])
    rank_j, crowd_j = jr.population_ranking(oj, vj, backend=backend)
    rank_t, crowd_t = tr.population_ranking(ot, vt, backend=backend)
    assert_bits_equal(rank_j, rank_t, f"{case} rank")
    assert_bits_equal(crowd_j, crowd_t, f"{case} crowd")


@pytest.mark.parametrize("backend", ["sweep", "matrix"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_select_rerank_matches_reference(seed, backend):
    rng = np.random.default_rng(seed)
    P, mu = 64, 32
    obj = (rng.integers(0, 12, (P, 2)) / 12.0).astype(np.float32)
    viol = np.maximum(0.0, rng.random(P).astype(np.float32) - 0.7)
    (oj, vj), (ot, vt) = _both(obj, viol)
    ref = jr.rank_select_rerank(oj, vj, mu, backend=backend)
    port = tr.rank_select_rerank(ot, vt, mu, backend=backend)
    for name, a, b in zip(("keep", "rank", "crowd"), ref, port):
        assert_bits_equal(a, b, f"{backend} {name}")


def test_fold_objectives_three_columns():
    rng = np.random.default_rng(4)
    obj = (rng.integers(0, 5, (40, 3)) / 5.0).astype(np.float32)
    assert_bits_equal(jr_ops.fold_objectives(jnp.asarray(obj)),
                      tr.fold_objectives(torch.as_tensor(obj)), "fold")
    two = torch.as_tensor(obj[:, :2])
    assert tr.fold_objectives(two) is two


def test_lexsort_is_stable_and_last_key_primary():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 3, 50)
    b = rng.integers(0, 3, 50)
    c = rng.random(50).astype(np.float32)
    ref = jnp.lexsort((jnp.asarray(c), jnp.asarray(a), jnp.asarray(b) > 0))
    port = tn.lexsort((torch.as_tensor(c), torch.as_tensor(a), torch.as_tensor(b) > 0))
    assert_bits_equal(ref, port, "lexsort")


def test_tournament_select_matches_reference():
    rng = np.random.default_rng(6)
    rank = rng.integers(0, 4, 16).astype(np.int32)
    crowd = rng.random(16).astype(np.float32)
    crowd[:3] = np.inf
    for seed in (0, 9):
        ref = jn.tournament_select(jax.random.PRNGKey(seed), jnp.asarray(rank),
                                   jnp.asarray(crowd), 16)
        port = tn.tournament_select(prng.PRNGKey(seed), torch.as_tensor(rank),
                                    torch.as_tensor(crowd), 16)
        assert_bits_equal(ref, port, f"seed {seed}")


def test_sweep_is_two_objective_only():
    with pytest.raises(ValueError, match="2-objective"):
        tr.sweep_rank(torch.zeros((4, 3)), torch.zeros(4))
    with pytest.raises(ValueError, match="backend"):
        tr.population_ranking(torch.zeros((4, 2)), torch.zeros(4), backend="nope")
