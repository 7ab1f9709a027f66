"""Each CUDA kernel against its plain version on the card (marker
``cuda``): pendigits-like shapes, row/sample bounds, device-variation
delta tables with K = 1 and 6, exact equality; the table kernels (K4, K1
and both branches of K3) at the paper's and the suite's topologies (in
their compiled widths), at a smaller one padded into them and at two their
general kernel runs, K = 1 and 50, exponents at both ends of their range,
ragged lanes (K3 nominal at the suite's 15), both K3 branches at 1, 3 and
5 pairs of children, each launcher's shared-memory size against its CPU
mirror and the size its wrapper checks, and the largest K the card admits
(where padded tables no longer fit and the general kernel runs);
the lane axis of the GA
kernels at L = 1 and 3 (unequal per-lane sample counts, a shared row
bound), one launch for all lanes; the probe kernel and its memo; the LM-side kernels at
small and ragged shapes (the state scan bit for bit, the pow2 product
within 1e-4 of the plain output's largest magnitude and its decode of every
code exact, attention within
3e-4 in float32 and ``flash_attention_bf16_limit`` in bfloat16); the
supervised server's checkpoint of a card server restored on the card and on
the CPU, leaf for leaf, and a poisoned lane quarantined on the card under
the watchdog, on the caller's side stream. The
tests skip, with a reason, where ``torch.cuda.is_available()`` is False;
``python3 chip_smoke.py`` runs the same comparisons at the main path's
full shapes. Run them on a card with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``
(``--noconftest``: the shared conftest imports jax, which a card host for
the port need not have; this file uses none of its fixtures)."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.quantize import pow2_dequantize
from repro_torch.core.genome import GenomeSpec, MLPTopology, _slot_keys, random_population
from repro_torch.kernels import _cuda
from repro_torch.kernels.pop_generation import pop_generation_kernel, pop_generation_plain
from repro_torch.kernels.pop_mlp import (pop_mlp_correct, pop_mlp_correct_mc,
                                         pop_mlp_correct_mc_plain, pop_mlp_correct_plain)
from repro_torch.kernels.pop_variation import pop_variation_kernel, pop_variation_plain
from repro_torch.kernels.flash_attention import (causal_attention, flash_attention,
                                                 flash_attention_bf16_limit,
                                                 flash_attention_plain)
from repro_torch.kernels.pow2_matmul import (pack_weights, pow2_linear, pow2_matmul,
                                             pow2_matmul_plain)
from repro_torch.kernels.ssd_scan import ssd_state_scan, ssd_state_scan_plain, state_scan

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


# K4 at the paper's five topologies and the suite's padded one (all run in its
# compiled widths), a smaller one padded into them, and two that only its
# general kernel runs (a hidden layer wider than the compiled widths', 3 layers)
MC_TOPOS = [(16, 5, 10), (21, 5, 10), (10, 3, 2), (21, 3, 3), (11, 2, 6), (11, 4, 7),
            (6, 4, 3), (5, 4, 3, 2), (6, 7, 3)]


def _mc_case(dev, sizes, K, P=40, S=700, seed=0):
    """A population whose exponent genes sit at 0 in some rows and at
    max_exp in others (the deltas push them past both ends), samples,
    labels and a (K, G) delta table."""
    spec = GenomeSpec(MLPTopology(sizes))
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec.low, spec.high, (P, spec.n_genes)).astype(np.int32)
    pop[0::3, spec.is_exp] = 0
    pop[1::3, spec.is_exp] = spec.topo.max_exp
    x = rng.integers(0, 2**spec.topo.input_bits, (S, sizes[0])).astype(np.int32)
    y = rng.integers(0, sizes[-1], S).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return spec, t(pop), t(x), t(y), _deltas(spec, K, dev, seed=seed), t(spec.high)


@pytest.mark.parametrize("K", [1, 50])
@pytest.mark.parametrize("sizes", MC_TOPOS)
def test_mc_kernel_every_topology_equals_plain(card, sizes, K):
    """K4 against its plain version with row and sample bounds and a masked
    output column; with all-zero deltas it equals K1."""
    spec, pop, x, y, dev, high = _mc_case(card, sizes, K, seed=len(sizes) + K)
    om = torch.ones(sizes[-1], dtype=torch.int32, device=card)
    om[-1] = 0
    for rows, samples, mask in ((40, None, None), (23, 555, om)):
        n = torch.tensor(rows, dtype=torch.int32, device=card)
        kw = dict(spec=spec, n_valid_rows=n, n_valid_samples=samples, out_mask=mask)
        before = _cuda.LAUNCHES["pop_mlp_correct_mc"]
        got = pop_mlp_correct_mc(pop, x, y, dev, high, **kw)
        assert _cuda.LAUNCHES["pop_mlp_correct_mc"] == before + 1
        want = pop_mlp_correct_mc_plain(pop, x, y, dev=dev, gene_high=high, **kw)
        assert tuple(got.shape) == (40, K) and torch.equal(got, want)
        assert (got[rows:] == 0).all()
        nominal = pop_mlp_correct(pop, x, y, **kw)
        assert torch.equal(got[:, 0], nominal)
        assert torch.equal(pop_mlp_correct_mc(pop, x, y, torch.zeros_like(dev), high, **kw),
                           nominal[:, None].expand(-1, K))


@pytest.mark.parametrize("sizes", [(21, 5, 10), (5, 4, 3, 2)])
def test_mc_kernel_lanes_with_ragged_samples_equal_plain(card, sizes):
    """Three lanes with their own sample counts (labels −1 past them), output
    masks and delta tables, and a row bound, in one launch."""
    L, K = 3, 9
    cases = [_mc_case(card, sizes, K, P=30, S=900, seed=i) for i in range(L)]
    spec = cases[0][0]
    pop, x, y, dev, high = (torch.stack([c[i] for c in cases]) for i in range(1, 6))
    samp = torch.tensor([900, 311, 5], dtype=torch.int32, device=card)
    for i in range(L):
        y[i, int(samp[i]):] = -1
    om = torch.ones((L, sizes[-1]), dtype=torch.int32, device=card)
    om[1, 0] = 0
    n = torch.tensor(17, dtype=torch.int32, device=card)
    kw = dict(spec=spec, n_valid_rows=n, n_valid_samples=samp, out_mask=om)
    got = pop_mlp_correct_mc(pop, x, y, dev, high, **kw)
    want = pop_mlp_correct_mc_plain(pop, x, y, dev=dev, gene_high=high, **kw)
    assert tuple(got.shape) == (L, 30, K) and torch.equal(got, want)
    assert (got[:, 17:] == 0).all()
    assert torch.equal(pop_mlp_correct_mc(pop, x, y, torch.zeros_like(dev), high, **kw),
                       pop_mlp_correct(pop, x, y, **kw)[..., None].expand(-1, -1, K))


@pytest.mark.parametrize("sizes", [(16, 5, 10), (21, 5, 10), (6, 4, 3)])
def test_mc_kernel_smem_check_agrees_with_its_launcher(card, sizes):
    """The size the wrapper checks is its launcher's
    (``pop_mlp_correct_mc_smem_bytes``), which ``ref.mc_smem_bytes``
    computes for the card's limit at every K; at the largest K the card
    admits, the kernel launches and equals its plain version, and one more
    instance is refused."""
    import ctypes

    from repro_torch.kernels.pop_mlp.kernel import net_desc
    from repro_torch.kernels.pop_mlp.ref import mc_smem_bytes

    spec = GenomeSpec(MLPTopology(sizes))
    desc = _cuda.host_ints(net_desc(spec))
    lib = _cuda.library()
    launcher = lambda K: lib.pop_mlp_correct_mc_smem_bytes(ctypes.cast(desc, ctypes.c_void_p), K)
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    for K in (1, 8, 50, 120, 200, 400):
        assert launcher(K) == mc_smem_bytes(sizes, K, limit)
    k_max = 1
    while launcher(k_max + 1) <= limit:
        k_max += 1
    spec, pop, x, y, dev, high = _mc_case(card, sizes, k_max, P=4, S=160, seed=k_max)
    got = pop_mlp_correct_mc(pop, x, y, dev, high, spec=spec)
    assert torch.equal(got, pop_mlp_correct_mc_plain(pop, x, y, spec=spec, dev=dev,
                                                     gene_high=high))
    with pytest.raises(ValueError, match="shared memory"):
        pop_mlp_correct_mc(pop, x, y, _deltas(spec, k_max + 1, card), high, spec=spec)


# -- K1 and K3's n_dev branch on the tables of per-instance multipliers --------

@pytest.mark.parametrize("sizes", MC_TOPOS)
def test_k1_every_topology_equals_plain(card, sizes):
    """K1 (the table kernel at one instance, deltas compiled out) against
    its plain version with row and sample bounds and a masked output
    column, at every topology K4 is tested on."""
    spec, pop, x, y, _, _ = _mc_case(card, sizes, 1, seed=len(sizes))
    om = torch.ones(sizes[-1], dtype=torch.int32, device=card)
    om[-1] = 0
    for rows, samples, mask in ((40, None, None), (23, 555, om), (0, None, om)):
        n = torch.tensor(rows, dtype=torch.int32, device=card)
        kw = dict(spec=spec, n_valid_rows=n, n_valid_samples=samples, out_mask=mask)
        before = _cuda.LAUNCHES["pop_mlp_correct"]
        got = pop_mlp_correct(pop, x, y, **kw)
        assert _cuda.LAUNCHES["pop_mlp_correct"] == before + 1
        want = pop_mlp_correct_plain(pop, x, y, **kw)
        assert tuple(got.shape) == (40,) and torch.equal(got, want)
        assert (got[rows:] == 0).all()


def _variation(dev, spec, pop, seed):
    """One population's variation operands: parent frames from the two
    halves of ``pop``, crossover gates, the gene table, slot keys and a
    mutation rate."""
    P = pop.shape[0] // 2
    rng = np.random.default_rng(seed)
    t = spec.table(dev)
    return (pop[:P].contiguous(), pop[P:2 * P].contiguous(),
            torch.as_tensor(rng.random(P) < 0.7, device=dev), t.low, t.high, t.is_mask,
            t.mask_bits, t.ids, _slot_keys(prng.PRNGKey(seed, dev), (0, 1, 2)),
            torch.tensor(0.3, dtype=torch.float32, device=dev))


def _check_generation_n_dev(args, x, y, dev, **kw):
    """K3's n_dev branch: one launch, equal to its plain version, the
    nominal branch's children, column 0 (zero deltas) the nominal count,
    all-zero deltas the nominal count on every instance."""
    before = _cuda.LAUNCHES["pop_generation_kernel_mc"]
    ch, cnt = pop_generation_kernel(*args, x, y, dev=dev, **kw)
    assert _cuda.LAUNCHES["pop_generation_kernel_mc"] == before + 1
    ch_p, cnt_p = pop_generation_plain(*args, x, y, dev=dev, **kw)
    assert cnt.shape == (*ch.shape[:-1], dev.shape[-2])
    assert torch.equal(ch, ch_p) and torch.equal(cnt, cnt_p)
    ch_n, cnt_n = pop_generation_kernel(*args, x, y, **kw)
    assert torch.equal(ch_n, ch) and torch.equal(cnt[..., 0], cnt_n)
    _, cnt_z = pop_generation_kernel(*args, x, y, dev=torch.zeros_like(dev), **kw)
    assert torch.equal(cnt_z, cnt_n[..., None].expand_as(cnt))


@pytest.mark.parametrize("K", [1, 50])
@pytest.mark.parametrize("sizes", MC_TOPOS)
def test_generation_n_dev_every_topology_equals_plain(card, sizes, K):
    """K3's n_dev branch (children made in the block, their tables built
    there) at every topology K4 is tested on, with and without a sample
    bound and a masked output column."""
    spec, pop, x, y, dev, _ = _mc_case(card, sizes, K, seed=len(sizes) + K)
    args = _variation(card, spec, pop, seed=K)
    om = torch.ones(sizes[-1], dtype=torch.int32, device=card)
    om[-1] = 0
    for samples, mask in ((None, None), (555, om)):
        _check_generation_n_dev(args, x, y, dev, spec=spec, n_valid_samples=samples,
                                out_mask=mask)


@pytest.mark.parametrize("P", [2, 6, 10])
def test_generation_n_dev_small_populations_equal_plain(card, P):
    """One pair of children a block: P / 2 = 1, 3 and 5 pairs, the odd ones
    drawing a pair's swaps from two Threefry counters."""
    spec, pop, x, y = _inputs(card, P=P, seed=P)
    _check_generation_n_dev(_variation(card, spec, pop, seed=P), x, y,
                            _deltas(spec, 8, card, seed=P), spec=spec)


@pytest.mark.parametrize("sizes", [(21, 5, 10), (5, 4, 3, 2)])
def test_table_kernels_lanes_with_ragged_samples_equal_plain(card, sizes):
    """K1 and K3's n_dev branch over three lanes with their own sample
    counts (labels −1 past them), output masks, delta tables, draw ids,
    keys and mutation rates, in one launch each; K1 with a row bound."""
    L, K, P = 3, 9, 16
    cases = [_mc_case(card, sizes, K, P=2 * P, S=900, seed=i) for i in range(L)]
    spec = cases[0][0]
    pop, x, y, dev, high = (torch.stack([c[i] for c in cases]) for i in range(1, 6))
    samp = torch.tensor([900, 311, 5], dtype=torch.int32, device=card)
    for i in range(L):
        y[i, int(samp[i]):] = -1
    om = torch.ones((L, sizes[-1]), dtype=torch.int32, device=card)
    om[1, 0] = 0
    kw = dict(spec=spec, n_valid_samples=samp, out_mask=om)
    n = torch.tensor(17, dtype=torch.int32, device=card)
    got = pop_mlp_correct(pop, x, y, n_valid_rows=n, **kw)
    assert tuple(got.shape) == (L, 2 * P) and (got[:, 17:] == 0).all()
    assert torch.equal(got, pop_mlp_correct_plain(pop, x, y, n_valid_rows=n, **kw))
    rng = np.random.default_rng(1)
    lanes = [_variation(card, spec, pop[i], seed=10 + i) for i in range(L)]
    args = [torch.stack([a[j] for a in lanes]) for j in range(10)]
    args[7] = torch.stack([torch.as_tensor(rng.permutation(spec.n_genes).astype(np.int32),
                                           device=card) for _ in range(L)])
    args[9] = torch.tensor([0.3, 0.05, 0.5], dtype=torch.float32, device=card)
    _check_generation_n_dev(tuple(args), x, y, dev, **kw)


@pytest.mark.parametrize("sizes", [(16, 5, 10), (21, 5, 10), (6, 4, 3)])
def test_table_kernels_smem_checks_agree_with_their_launchers(card, sizes):
    """The sizes K1's and K3 n_dev's wrappers check are their launchers'
    (``pop_mlp_correct_smem_bytes``, ``pop_generation_mc_smem_bytes``),
    which ``ref.k1_smem_bytes`` and ``ref.generation_mc_smem_bytes``
    compute for the card's limit; at the largest K the card admits, K3's
    n_dev branch launches and equals its plain version, and one more
    instance is refused."""
    import ctypes

    from repro_torch.kernels.pop_mlp.kernel import net_desc
    from repro_torch.kernels.pop_mlp.ref import generation_mc_smem_bytes, k1_smem_bytes

    spec = GenomeSpec(MLPTopology(sizes))
    G = spec.n_genes
    desc = ctypes.cast(_cuda.host_ints(net_desc(spec)), ctypes.c_void_p)
    lib = _cuda.library()
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    assert lib.pop_mlp_correct_smem_bytes(desc) == k1_smem_bytes(sizes, limit)
    launcher = lambda K: lib.pop_generation_mc_smem_bytes(desc, G, K)
    for K in (1, 8, 50, 120, 200, 400):
        assert launcher(K) == generation_mc_smem_bytes(sizes, G, K, limit), K
    k_max = 1
    while launcher(k_max + 1) <= limit:
        k_max += 1
    spec, pop, x, y, dev, _ = _mc_case(card, sizes, k_max, P=8, S=160, seed=k_max)
    _check_generation_n_dev(_variation(card, spec, pop, seed=k_max), x, y, dev, spec=spec)
    with pytest.raises(ValueError, match="shared memory"):
        pop_generation_kernel(*_variation(card, spec, pop, seed=k_max), x, y, spec=spec,
                              dev=_deltas(spec, k_max + 1, card))


# -- K3's nominal branch on the tables at one instance -----------------------

def _check_generation_nominal(args, x, y, **kw):
    """K3's nominal branch: one launch, children and (…, P) counts equal to
    its plain version, the children K2's."""
    before = _cuda.LAUNCHES["pop_generation_kernel"]
    ch, cnt = pop_generation_kernel(*args, x, y, **kw)
    assert _cuda.LAUNCHES["pop_generation_kernel"] == before + 1
    ch_p, cnt_p = pop_generation_plain(*args, x, y, **kw)
    assert cnt.shape == ch.shape[:-1] and cnt.dtype == torch.int32
    assert torch.equal(ch, ch_p) and torch.equal(cnt, cnt_p)
    assert torch.equal(ch, pop_variation_plain(*args))


@pytest.mark.parametrize("sizes", MC_TOPOS)
def test_generation_nominal_every_topology_equals_plain(card, sizes):
    """K3's nominal branch (children made in the block, their tables built
    there at one instance) at every topology K4 is tested on, with and
    without a sample bound and a masked output column."""
    spec, pop, x, y, _, _ = _mc_case(card, sizes, 1, seed=len(sizes) + 7)
    args = _variation(card, spec, pop, seed=len(sizes))
    om = torch.ones(sizes[-1], dtype=torch.int32, device=card)
    om[-1] = 0
    for samples, mask in ((None, None), (555, om)):
        _check_generation_nominal(args, x, y, spec=spec, n_valid_samples=samples,
                                  out_mask=mask)


@pytest.mark.parametrize("P", [2, 6, 10])
def test_generation_nominal_small_populations_equal_plain(card, P):
    """P / 2 = 1, 3 and 5 pairs of children: a tile past the population's
    end, and odd pair counts drawing a pair's swaps from two Threefry
    counters."""
    spec, pop, x, y = _inputs(card, P=P, seed=P + 1)
    _check_generation_nominal(_variation(card, spec, pop, seed=P + 1), x, y, spec=spec)


def test_generation_nominal_fifteen_lanes_with_ragged_samples_equal_plain(card):
    """The suite's shape: 15 lanes of P = 64 at the padded (21, 5, 10), S =
    7696 rows a lane of which each counts its own (labels −1 past them,
    one lane none, one fewer than a block's chunk), their own output masks,
    draw ids, keys and mutation rates, in one launch."""
    L, P, S, sizes = 15, 64, 7696, (21, 5, 10)
    cases = [_mc_case(card, sizes, 1, P=2 * P, S=S, seed=20 + i) for i in range(L)]
    spec = cases[0][0]
    pop, x, y = (torch.stack([c[i] for c in cases]) for i in range(1, 4))
    rng = np.random.default_rng(15)
    samp = torch.as_tensor([S, 0, 100, 489, 5000, *rng.integers(1, S, L - 5)],
                           dtype=torch.int32, device=card)
    for i in range(L):
        y[i, int(samp[i]):] = -1
    om = torch.ones((L, sizes[-1]), dtype=torch.int32, device=card)
    om[::4, 3:] = 0
    lanes = [_variation(card, spec, pop[i], seed=30 + i) for i in range(L)]
    args = [torch.stack([a[j] for a in lanes]) for j in range(10)]
    args[7] = torch.stack([torch.as_tensor(rng.permutation(spec.n_genes).astype(np.int32),
                                           device=card) for _ in range(L)])
    args[9] = torch.as_tensor(rng.random(L) * 0.4, dtype=torch.float32, device=card)
    _check_generation_nominal(tuple(args), x, y, spec=spec, n_valid_samples=samp, out_mask=om)


@pytest.mark.parametrize("sizes", [(16, 5, 10), (21, 5, 10), (6, 4, 3), (5, 4, 3, 2)])
def test_generation_nominal_smem_check_agrees_with_its_launcher(card, sizes, monkeypatch):
    """The size K3 nominal's wrapper checks is its launcher's
    (``pop_generation_smem_bytes``), which ``ref.generation_smem_bytes``
    computes for the card's limit."""
    import ctypes

    from repro_torch.kernels.pop_mlp.kernel import net_desc
    from repro_torch.kernels.pop_mlp.ref import generation_smem_bytes

    spec, pop, x, y, _, _ = _mc_case(card, sizes, 1, P=8, S=300, seed=3)
    G = spec.n_genes
    desc = ctypes.cast(_cuda.host_ints(net_desc(spec)), ctypes.c_void_p)
    launcher = _cuda.library().pop_generation_smem_bytes(desc, G)
    limit = torch.cuda.get_device_properties(card).shared_memory_per_block_optin
    assert launcher == generation_smem_bytes(sizes, G, limit)
    checked = []
    check = _cuda.check_smem
    monkeypatch.setattr(_cuda, "check_smem",
                        lambda n, dev, what: checked.append(n) or check(n, dev, what))
    _check_generation_nominal(_variation(card, spec, pop, seed=3), x, y, spec=spec)
    assert checked == [launcher]


def _lanes(dev, L, P=40, S=1100, seed=0):
    """L lanes of one layout with their own genomes, samples, labels (−1
    past each lane's own, unequal sample count), output masks, delta
    tables, parent frames, gene tables (own draw ids), keys and rates."""
    spec = GenomeSpec(MLPTopology((16, 5, 10)))
    rng = np.random.default_rng(seed)
    t = spec.table(dev)
    pop = torch.stack([random_population(prng.PRNGKey(seed + i, dev), t, 2 * P)
                       for i in range(L)])
    x = torch.as_tensor(rng.integers(0, 16, (L, S, 16)), dtype=torch.int32, device=dev)
    y = torch.as_tensor(rng.integers(0, 10, (L, S)), dtype=torch.int32, device=dev)
    samp = torch.as_tensor(rng.integers(S // 4, S + 1, L), dtype=torch.int32, device=dev)
    for i in range(L):
        y[i, int(samp[i]):] = -1
    om = torch.ones((L, 10), dtype=torch.int32, device=dev)
    om[:, 9] = torch.as_tensor(rng.integers(0, 2, L), dtype=torch.int32, device=dev)
    deltas = torch.stack([_deltas(spec, 4, dev, seed=seed + i) for i in range(L)])
    ids = torch.stack([torch.as_tensor(rng.permutation(spec.n_genes).astype(np.int32),
                                       device=dev) for _ in range(L)])
    tables = [a.expand(L, -1).contiguous() for a in (t.low, t.high, t.is_mask, t.mask_bits)]
    keys = torch.stack([_slot_keys(prng.PRNGKey(seed + 7 * i, dev), (0, 1, 2))
                        for i in range(L)])
    var = (pop[:, :P].contiguous(), pop[:, P:].contiguous(),
           torch.as_tensor(rng.random((L, P)) < 0.7, device=dev), *tables, ids, keys,
           torch.as_tensor(rng.random(L) * 0.4, dtype=torch.float32, device=dev))
    return spec, pop, x, y, samp, om, deltas, var


@pytest.mark.parametrize("L", [1, 3])
def test_lane_axis_kernels_equal_plain(card, L):
    """Each lane-axis kernel (one launch for all lanes) against its plain
    version, with unequal per-lane sample counts and a shared row bound
    below P."""
    spec, pop, x, y, samp, om, deltas, var = _lanes(card, L, seed=L)
    rows = torch.tensor(53, dtype=torch.int32, device=card)
    hi = var[4]
    kw = dict(spec=spec, n_valid_samples=samp, out_mask=om)
    _cuda.reset_launches()
    got = pop_mlp_correct(pop, x, y, n_valid_rows=rows, **kw)
    got_mc = pop_mlp_correct_mc(pop, x, y, deltas, hi, n_valid_rows=rows, **kw)
    ch = pop_variation_kernel(*var)
    ch_g, cnt_g = pop_generation_kernel(*var, x, y, **kw)
    ch_m, cnt_m = pop_generation_kernel(*var, x, y, dev=deltas, **kw)
    assert {k: v for k, v in _cuda.LAUNCHES.items() if v} == {
        "pop_mlp_correct": 1, "pop_mlp_correct_mc": 1, "pop_variation_kernel": 1,
        "pop_generation_kernel": 1, "pop_generation_kernel_mc": 1}
    assert torch.equal(got, pop_mlp_correct_plain(pop, x, y, n_valid_rows=rows, **kw))
    assert tuple(got.shape) == (L, 80) and (got[:, 53:] == 0).all()
    assert torch.equal(got_mc, pop_mlp_correct_mc_plain(pop, x, y, dev=deltas, gene_high=hi,
                                                        n_valid_rows=rows, **kw))
    assert torch.equal(got_mc[..., 0], got)
    assert torch.equal(ch, pop_variation_plain(*var))
    ch_p, cnt_p = pop_generation_plain(*var, x, y, **kw)
    assert torch.equal(ch_g, ch_p) and torch.equal(cnt_g, cnt_p)
    ch_q, cnt_q = pop_generation_plain(*var, x, y, dev=deltas, **kw)
    assert torch.equal(ch_m, ch_q) and torch.equal(cnt_m, cnt_q) and torch.equal(ch_m, ch)


def test_one_lane_launch_equals_the_single_problem_launch(card):
    """L = 1 in lane form and the single-problem form each launch their
    kernel once and give the same results."""
    spec, pop, x, y, samp, om, deltas, var = _lanes(card, 1, seed=5)
    rows = torch.tensor(77, dtype=torch.int32, device=card)
    one = [a[0] for a in var]
    calls = {
        "pop_mlp_correct": (
            lambda: pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=rows,
                                    n_valid_samples=samp, out_mask=om)[0],
            lambda: pop_mlp_correct(pop[0], x[0], y[0], spec=spec, n_valid_rows=rows,
                                    n_valid_samples=samp[0], out_mask=om[0])),
        "pop_variation_kernel": (lambda: pop_variation_kernel(*var)[0],
                                 lambda: pop_variation_kernel(*one)),
        "pop_generation_kernel_mc": (
            lambda: pop_generation_kernel(*var, x, y, spec=spec, dev=deltas,
                                          n_valid_samples=samp)[1][0],
            lambda: pop_generation_kernel(*one, x[0], y[0], spec=spec, dev=deltas[0],
                                          n_valid_samples=samp[0])[1])}
    for name, (lanes, single) in calls.items():
        _cuda.reset_launches()
        a = lanes()
        assert _cuda.LAUNCHES[name] == 1
        b = single()
        assert _cuda.LAUNCHES[name] == 2 and sum(_cuda.LAUNCHES.values()) == 2
        assert torch.equal(a, b), name


def test_lane_wrappers_reject_shape_mismatches(card):
    spec, pop, x, y, samp, om, deltas, var = _lanes(card, 3)
    with pytest.raises(ValueError, match="x_int"):
        pop_mlp_correct(pop, x[:2], y, spec=spec)
    with pytest.raises(ValueError, match="labels"):
        pop_mlp_correct(pop, x, y[:, :5], spec=spec)
    with pytest.raises(ValueError, match="per-lane bound"):
        pop_mlp_correct(pop, x, y, spec=spec, n_valid_samples=samp[:2])
    with pytest.raises(ValueError, match="out_mask"):
        pop_mlp_correct(pop, x, y, spec=spec, out_mask=om[0])
    with pytest.raises(ValueError, match="dev"):
        pop_mlp_correct_mc(pop, x, y, deltas[:2], var[4], spec=spec)
    with pytest.raises(ValueError, match="gene_high"):
        pop_mlp_correct_mc(pop, x, y, deltas, var[4][0], spec=spec)
    with pytest.raises(ValueError, match="keys"):
        pop_variation_kernel(*var[:8], var[8][:2], var[9])
    with pytest.raises(ValueError, match="pm_gene"):
        pop_variation_kernel(*var[:9], var[9][:1])
    with pytest.raises(ValueError, match="x_int"):
        pop_generation_kernel(*var, x[:1], y[:1], spec=spec)


def test_probe_kernel_memo_and_reset(card, monkeypatch):
    """The probe kernel adds 1 on the card; ``resolve_backends(...,
    fallback=True)`` launches it once, downgrades nothing, and answers from
    its memo after; a reset memo asks again."""
    import warnings

    from repro_torch.kernels import backend
    from repro_torch.kernels.probe import PROBE_SHAPE, probe_kernel, probe_plain

    x = torch.arange(8 * 128, dtype=torch.int32, device=card).reshape(PROBE_SHAPE)
    assert torch.equal(probe_kernel(x), probe_plain(x))
    monkeypatch.setattr(backend, "_KERNEL_OK", {})
    monkeypatch.setattr(backend, "_WARNED", set())
    pol = backend.BackendPolicy(fitness="kernel", variation="kernel", generation="kernel",
                                ranking="sweep")
    _cuda.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert backend.resolve_backends(pol, fallback=True) == pol
        assert _cuda.LAUNCHES["probe"] == 1 and backend._KERNEL_OK == {"compiled": True}
        assert backend.resolve_backends(pol, fallback=True) == pol
    assert _cuda.LAUNCHES["probe"] == 1
    monkeypatch.setattr(backend, "_KERNEL_OK", {})
    assert backend.backend_available("fitness", "kernel")
    assert _cuda.LAUNCHES["probe"] == 2


@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 1), (2, 3, 5, 7, 9), (2, 9, 24, 64, 128)])
def test_ssd_scan_kernel_equals_plain(card, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    sc = torch.randn(shape, generator=g, device=card)
    dec = torch.rand(shape[:3], generator=g, device=card)
    before = _cuda.LAUNCHES["ssd_state_scan"]
    got = state_scan(sc, dec)
    assert _cuda.LAUNCHES["ssd_state_scan"] == before + 1
    want = ssd_state_scan_plain(sc, dec)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,offset", [
    (128, 128, 128, 0), (77, 100, 130, 0), (1, 5, 3, 0), (256, 384, 512, 0), (200, 256, 384, 0),
    # the bf16 kernel's edges: M ragged against its 256-row tile, N against
    # 128, K against its 64-deep slice; more slices than its 4 ring stages
    (255, 128, 128, 0), (257, 128, 128, 0), (128, 128, 129, 0), (128, 65, 128, 0),
    (512, 1024, 512, 0),
    # K not a multiple of 8 and N not of 16 (the wrapper pads), and x a view
    # whose storage is not 16-byte aligned (the wrapper copies it)
    (300, 1030, 200, 0), (96, 256, 384, 1), (77, 100, 130, 3)])
def test_pow2_matmul_kernel_equals_plain(card, dtype, M, K, N, offset):
    g = torch.Generator(device=card).manual_seed(M + K + N)
    buf = torch.empty(M * K + offset, device=card, dtype=dtype)
    buf[offset:] = torch.randn((M * K,), generator=g, device=card).to(dtype)
    x = buf[offset:].view(M, K)
    wp = pack_weights(torch.randn((K, N), generator=g, device=card) * 0.1)
    before = _cuda.LAUNCHES["pow2_matmul"]
    got = pow2_linear(x[None], wp)[0]
    assert _cuda.LAUNCHES["pow2_matmul"] == before + 1
    want = pow2_matmul_plain(x, wp)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    zero = pack_weights(torch.zeros((K, N), device=card))
    assert pow2_matmul(x, zero).abs().max() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pow2_matmul_decodes_every_code_exactly(card, dtype):
    """x the identity (K = 256) and weights holding each of the 256 codes
    in every column position mod 128: each output is one exact product, so
    the kernel's output is the decoded weights, bit for bit where they are
    not zero (0x7F gives 0, 0xFF -2^64, 0x00 2^-63)."""
    K, N = 256, 256
    x = torch.eye(K, device=card, dtype=dtype)
    k, n = torch.meshgrid(torch.arange(K, device=card), torch.arange(N, device=card),
                          indexing="ij")
    wp = ((k + n) % 256).to(torch.uint8)
    got = pow2_matmul(x, wp)
    want = pow2_dequantize(wp, torch.float32)
    assert torch.equal(got, want)
    nz = want != 0
    assert torch.equal(got.view(torch.int32)[nz], want.view(torch.int32)[nz])
    assert (want[wp == 0x7F] == 0).all() and (want[wp == 0xFF] == -2.0**64).all()
    assert (want[wp == 0x00] == 2.0**-63).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,D,Dv", [
    (2, 100, 32, 16), (3, 130, 64, 128), (1, 1, 8, 8), (2, 257, 128, 128), (4, 128, 16, 48),
    (2, 2048, 128, 128),
    # the bf16 kernel's edges: S ragged against its 128-query and 128-key tiles
    (1, 127, 128, 128), (1, 129, 128, 128), (1, 4097, 128, 128),
    # minicpm3's MLA widths and zamba2's, compiled for 128/64 and 64/64
    (3, 257, 96, 64), (5, 129, 64, 64),
    # widths the wrapper pads with zero columns (TMA's 16-byte strides), with
    # several heads of ragged S: a row written past a head's end lands in the next
    (3, 200, 7, 5), (4, 300, 36, 100)])
def test_flash_attention_kernel_equals_plain(card, dtype, BH, S, D, Dv):
    g = torch.Generator(device=card).manual_seed(BH * S + D)
    q, k, v = (torch.randn((BH, S, d), generator=g, device=card).to(dtype) for d in (D, D, Dv))
    before = _cuda.LAUNCHES["flash_attention"]
    got = causal_attention(q, k, v, block_q=S, block_k=S)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        limit = flash_attention_bf16_limit(q, k, v, want)
        assert ((got.float() - want.float()).abs() <= limit).all()


@pytest.mark.parametrize("D,Dv", [(128, 128), (96, 64), (64, 64), (7, 5)])
@pytest.mark.parametrize("S", [1, 63, 65, 200, 4096])
def test_flash_attention_f32_kernel_equals_plain(card, S, D, Dv):
    """The float32 kernel over several heads at sequence lengths around its
    64-key and 128-query tiles and at qwen3-14b's prefill length, at the
    widths it is compiled for (Dv up to 64 and up to 128) and at widths the
    wrapper pads to multiples of 4, within 3e-4."""
    BH = 3
    g = torch.Generator(device=card).manual_seed(S + D + Dv)
    q, k, v = (torch.randn((BH, S, d), generator=g, device=card) for d in (D, D, Dv))
    before = _cuda.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, block_q=S, block_k=S)
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    want = flash_attention_plain(q, k, v)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)


def test_lm_wrappers_reject_bad_inputs(card):
    sc, dec = torch.zeros((1, 2, 4, 4, 4), device=card), torch.ones((1, 2, 4), device=card)
    with pytest.raises(TypeError, match="dtype"):
        ssd_state_scan(sc.double(), dec)
    with pytest.raises(ValueError, match="shape"):
        ssd_state_scan(sc, dec[:, :1])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_state_scan(sc.transpose(3, 4).contiguous().transpose(3, 4), dec)
    with pytest.raises(ValueError, match="on cpu"):
        ssd_state_scan(sc, dec.cpu())
    x, wp = torch.zeros((4, 8), device=card), torch.zeros((8, 4), dtype=torch.uint8, device=card)
    with pytest.raises(TypeError, match="dtype"):
        pow2_matmul(x.half(), wp)
    with pytest.raises(TypeError, match="dtype"):
        pow2_matmul(x, wp.to(torch.int8))
    with pytest.raises(ValueError, match="contiguous"):
        pow2_matmul(x, wp.t().contiguous().t())
    with pytest.raises(ValueError, match="on cpu"):
        pow2_matmul(x, wp.cpu())
    q = torch.zeros((2, 16, 8), device=card)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q[:, :, :4], q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="D, Dv"):
        wide = torch.zeros((1, 16, 160), device=card)
        flash_attention(wide, wide, q[:1])


# -- the supervised server on the card ------------------------------------------------

def _serve_problems(dev):
    from repro_torch.core import GAConfig, engine

    cfg = GAConfig(pop_size=16, generations=8)
    probs = {}
    for name, (seed, n, sizes) in {"a": (1, 64, (4, 4, 2)), "b": (2, 96, (5, 6, 2))}.items():
        rng = np.random.default_rng(seed)
        x = rng.random((n, sizes[0])).astype(np.float32)
        y = (x.sum(axis=1) > sizes[0] / 2).astype(np.int32)
        probs[name] = ((MLPTopology(sizes), x, y),
                       engine.Problem.from_data(MLPTopology(sizes), x, y, cfg, device=dev))
    return probs, cfg


def test_server_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A card server saved mid-flight (one job queued): restored on the card
    and on the CPU, every leaf equals the card server's; the card restore
    (the default device) takes the queued job back and drains to the
    uninterrupted run's results."""
    from repro_torch.checkpoint import manager
    from repro_torch.serve import SearchServer

    probs, cfg = _serve_problems(card)
    srv = SearchServer.for_problems([p for _, p in probs.values()], n_lanes=2, segment_len=4)
    for name, gens, seed in (("a", 12, 0), ("b", 8, 1), ("a", 4, 2)):
        srv.submit(probs[name][1], generations=gens, seed=seed, name=f"{name}{seed}")
    srv.step()
    srv.save(str(tmp_path), allow_pending=True)
    want = dict(manager.named_leaves((srv._states, srv._problems)))
    for dev in (card, torch.device("cpu")):
        rest = SearchServer.restore(str(tmp_path), srv.spec, cfg, device=dev)
        assert rest.active_jobs == srv.active_jobs and rest.segments_done == 1
        assert [p["name"] for p in rest.dropped_pending] == ["a2"]
        got = dict(manager.named_leaves((rest._states, rest._problems)))
        assert sorted(got) == sorted(want)
        for name, leaf in got.items():
            assert leaf.device.type == dev.type and leaf.dtype == want[name].dtype, name
            assert torch.equal(leaf.cpu(), want[name].cpu()), name
    rest = SearchServer.restore(str(tmp_path), srv.spec, cfg)     # the card by default
    rest.submit(probs["a"][1], generations=4, seed=2, name="a2")
    resumed = {r.name: r for r in rest.drain()}
    for r in srv.drain():
        for f in ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen"):
            assert torch.equal(getattr(resumed[r.name].state, f), getattr(r.state, f)), f
        assert (resumed[r.name].unique_evals, resumed[r.name].cache_hits) == \
            (r.unique_evals, r.cache_hits)


@pytest.mark.parametrize("leaf,check", [("obj", "finite_objectives"),
                                        ("counts", "counts_in_range")])
def test_poisoned_lane_quarantined_on_the_card(card, leaf, check):
    """The chaos plan poisons lane 0 after its first segment: the supervisor
    quarantines that job alone, naming the tripped check, and the sibling
    equals its ``GATrainer.run`` on the card. The stream runs under the
    watchdog on a side stream: each segment runs on the watchdog's thread
    under the caller's stream, and the kernels launch there."""
    import dataclasses

    from repro_torch.core import GATrainer
    from repro_torch.kernels import _cuda
    from repro_torch.serve import ChaosPlan, FaultPolicy, Supervisor

    probs, cfg = _serve_problems(card)
    sup = Supervisor.for_problems([p for _, p in probs.values()],
                                  FaultPolicy(segment_timeout_s=600.0),
                                  chaos=ChaosPlan(poison={0: 0}, poison_leaf=leaf),
                                  n_lanes=2, segment_len=4)
    assert sup.server.device.type == card.type
    sup.submit(probs["a"][1], generations=12, seed=3, name="poisoned")
    sup.submit(probs["b"][1], generations=8, seed=4, name="healthy")
    seen, step = [], sup.server.step

    def step_seen():
        seen.append((threading.get_ident(), torch.cuda.current_stream(card)))
        return step()

    sup.server.step = step_seen
    side = torch.cuda.Stream(card)
    torch.cuda.synchronize(card)
    _cuda.reset_launches()
    with torch.cuda.stream(side):
        results = {r.name: r for r in sup.drain()}
    torch.cuda.synchronize(card)
    # two segments: both lanes for 4 generations, then the healthy lane for 4
    assert len(seen) == 2 and all(t != threading.get_ident() and s == side for t, s in seen)
    assert (_cuda.LAUNCHES["pop_mlp_correct"], _cuda.LAUNCHES["pop_generation_kernel"]) == (2, 8)
    bad, good = results["poisoned"], results["healthy"]
    assert not bad.ok and bad.front is None and bad.generations_run == 4
    assert bad.error == f"lane 0 failed validation at segment 1: {check}"
    assert sup.stats["quarantined"] == 1 and good.ok
    tr = GATrainer(*probs["b"][0], dataclasses.replace(cfg, seed=4, generations=8),
                   device=card)
    state, _ = tr.run()
    for f in ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen"):
        assert torch.equal(getattr(good.state, f), getattr(state, f)), f
