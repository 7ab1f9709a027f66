"""Each CUDA kernel against its plain version on the card (marker
``cuda``): pendigits-like shapes, row/sample bounds, device-variation
delta tables with K = 1 and 6, exact equality. The
tests skip, with a reason, where ``torch.cuda.is_available()`` is False;
``python3 chip_smoke.py`` runs the same comparisons at the main path's
full shapes. Run them on a card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest imports jax, which a card host for
the port need not have; this file uses none of its fixtures)."""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.genome import GenomeSpec, MLPTopology, _slot_keys, random_population
from repro_torch.kernels import _cuda
from repro_torch.kernels.pop_generation import pop_generation_kernel, pop_generation_plain
from repro_torch.kernels.pop_mlp import (pop_mlp_correct, pop_mlp_correct_mc,
                                         pop_mlp_correct_mc_plain, pop_mlp_correct_plain)
from repro_torch.kernels.pop_variation import pop_variation_kernel, pop_variation_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(dev, P=64, S=1000, seed=0):
    spec = GenomeSpec(MLPTopology((16, 5, 10)))
    rng = np.random.default_rng(seed)
    pop = random_population(prng.PRNGKey(seed, dev), spec.table(dev), 2 * P)
    x = torch.as_tensor(rng.integers(0, 16, (S, 16)).astype(np.int32), device=dev)
    y = torch.as_tensor(rng.integers(0, 10, S).astype(np.int32), device=dev)
    return spec, pop, x, y


@pytest.mark.parametrize("rows,samples", [(128, None), (37, 600), (0, None)])
def test_fitness_kernel_equals_plain(card, rows, samples):
    spec, pop, x, y = _inputs(card)
    n = torch.tensor(rows, dtype=torch.int32, device=card)
    before = _cuda.LAUNCHES["pop_mlp_correct"]
    got = pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=n, n_valid_samples=samples)
    assert _cuda.LAUNCHES["pop_mlp_correct"] == before + 1
    want = pop_mlp_correct_plain(pop, x, y, spec=spec, n_valid_rows=n,
                                 n_valid_samples=samples)
    assert torch.equal(got, want)


@pytest.mark.parametrize("P", [6, 64])
def test_variation_and_generation_kernels_equal_plain(card, P):
    spec, pop, x, y = _inputs(card, P=P)
    t = spec.table(card)
    do = torch.rand(P, device=card) < 0.7
    keys = _slot_keys(prng.PRNGKey(P, card), (0, 1, 2))
    pm = torch.tensor(0.3, device=card)
    args = (pop[:P].contiguous(), pop[P:].contiguous(), do, t.low, t.high,
            t.is_mask, t.mask_bits, t.ids, keys, pm)
    assert torch.equal(pop_variation_kernel(*args), pop_variation_plain(*args))
    ch, cnt = pop_generation_kernel(*args, x, y, spec=spec)
    ch_p, cnt_p = pop_generation_plain(*args, x, y, spec=spec)
    assert torch.equal(ch, ch_p) and torch.equal(cnt, cnt_p)


def _deltas(spec, K, dev, seed=0):
    """A (K, G) delta table like ``engine.device_deltas``: row 0 zero,
    ±1 on about half the exponent genes elsewhere."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-1, 2, (K, spec.n_genes)).astype(np.int32) * spec.is_exp
    d[0] = 0
    return torch.as_tensor(d, device=dev)


@pytest.mark.parametrize("K", [1, 6])
@pytest.mark.parametrize("rows,samples", [(128, None), (37, 600)])
def test_mc_fitness_kernel_equals_plain(card, K, rows, samples):
    spec, pop, x, y = _inputs(card)
    dev, high = _deltas(spec, K, card, seed=K), torch.as_tensor(spec.high, device=card)
    n = torch.tensor(rows, dtype=torch.int32, device=card)
    om = torch.tensor([1] * 9 + [0], dtype=torch.int32, device=card)
    before = _cuda.LAUNCHES["pop_mlp_correct_mc"]
    got = pop_mlp_correct_mc(pop, x, y, dev, high, spec=spec, n_valid_rows=n,
                             n_valid_samples=samples, out_mask=om)
    assert _cuda.LAUNCHES["pop_mlp_correct_mc"] == before + 1
    want = pop_mlp_correct_mc_plain(pop, x, y, spec=spec, dev=dev, gene_high=high,
                                    n_valid_rows=n, n_valid_samples=samples, out_mask=om)
    assert tuple(got.shape) == (2 * 64, K) and torch.equal(got, want)
    assert (got[rows:] == 0).all()
    # the nominal instance (row 0 of the deltas) is K1's count
    nom = pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=n, n_valid_samples=samples,
                          out_mask=om)
    assert torch.equal(got[:, 0], nom)


@pytest.mark.parametrize("K", [1, 6])
def test_generation_kernel_n_dev_equals_plain(card, K):
    P = 64
    spec, pop, x, y = _inputs(card, P=P, seed=K)
    t = spec.table(card)
    do = torch.rand(P, device=card) < 0.7
    keys = _slot_keys(prng.PRNGKey(K, card), (0, 1, 2))
    args = (pop[:P].contiguous(), pop[P:].contiguous(), do, t.low, t.high,
            t.is_mask, t.mask_bits, t.ids, keys, torch.tensor(0.3, device=card))
    dev = _deltas(spec, K, card, seed=K)
    before = _cuda.LAUNCHES["pop_generation_kernel_mc"]
    ch, cnt = pop_generation_kernel(*args, x, y, spec=spec, dev=dev)
    assert _cuda.LAUNCHES["pop_generation_kernel_mc"] == before + 1
    ch_p, cnt_p = pop_generation_plain(*args, x, y, spec=spec, dev=dev)
    assert tuple(cnt.shape) == (P, K)
    assert torch.equal(ch, ch_p) and torch.equal(cnt, cnt_p)
    ch_n, cnt_n = pop_generation_kernel(*args, x, y, spec=spec)
    assert torch.equal(ch_n, ch) and torch.equal(cnt_n, cnt[:, 0])


def test_wrappers_reject_bad_inputs(card):
    spec, pop, x, y = _inputs(card)
    with pytest.raises(TypeError, match="dtype"):
        pop_mlp_correct(pop.long(), x, y, spec=spec)
    with pytest.raises(ValueError, match="contiguous"):
        pop_mlp_correct(pop.t().contiguous().t(), x, y, spec=spec)
    high = torch.as_tensor(spec.high, device=card)
    with pytest.raises(ValueError, match="dev"):
        pop_mlp_correct_mc(pop, x, y, _deltas(spec, 2, card)[:, :5], high, spec=spec)
    with pytest.raises(ValueError, match="shared memory"):
        pop_mlp_correct_mc(pop, x, y, _deltas(spec, 200, card), high, spec=spec)
