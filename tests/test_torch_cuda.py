"""Each CUDA kernel against its plain version on the card (marker
``cuda``): pendigits-like shapes, row/sample bounds, exact equality. The
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
from repro_torch.kernels.pop_mlp import pop_mlp_correct, pop_mlp_correct_plain
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


def test_wrappers_reject_bad_inputs(card):
    spec, pop, x, y = _inputs(card)
    with pytest.raises(TypeError, match="dtype"):
        pop_mlp_correct(pop.long(), x, y, spec=spec)
    with pytest.raises(ValueError, match="contiguous"):
        pop_mlp_correct(pop.t().contiguous().t(), x, y, spec=spec)
