"""The port's device-variation Monte-Carlo fitness against the reference
(modelled on tests/test_device_variation.py and tests/test_device_rng.py):
the delta table, the per-gene clip, the (P, K) fitness of the plain paths
and of both CUDA kernels' plain versions (against the Pallas kernels in
interpret mode), the float32 order of the robust objective, and
``GATrainer.run`` with ``variation_mode="mean"``/``"worst"`` under every
dedup mode and generation backend; tolerance 0."""
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import GAConfig as JCfg, GATrainer as JTrainer, engine as jeng
from repro.core import genome as jg, quantize as jq
from repro.core.genome import MLPTopology as JTopo
from repro.kernels.pop_generation import population_generation as j_gen
from repro.kernels.pop_generation.kernel import pop_generation_kernel as j_gen_kernel
from repro.kernels.pop_mlp import population_correct as j_correct
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine, prng
from repro_torch.core import genome as tg, quantize as tq
from repro_torch.core.interop import state_from_numpy, state_to_numpy
from repro_torch.kernels.backend import BackendPolicy
from repro_torch.kernels.pop_generation import (pop_generation_kernel,
                                                pop_generation_plain,
                                                population_generation)
from repro_torch.kernels.pop_mlp.ref import (H100_SMEM_OPTIN, MC_BUCKETS, MC_TILES,
                                             generation_mc_smem_bytes, k1_smem_bytes,
                                             mc_bucket, mc_layout, mc_smem_bytes, mc_tables,
                                             pop_mlp_correct_mc_tables)
from repro_torch.kernels.pop_mlp import (population_correct, pop_mlp_correct_mc,
                                         pop_mlp_correct_mc_plain)
from repro_torch.kernels.pop_variation import pop_variation_plain
from test_torch_interop import (NO_COUNTS, assert_bits_equal, assert_states_equal,
                                jax_leaves, kernel_paths_on_cpu)

TOPO = (6, 4, 2)
RNG = np.random.default_rng(42)
X = RNG.random((96, 6)).astype(np.float32)
Y = (X.sum(axis=1) > 3.0).astype(np.int32)


def _problems(sizes=TOPO, x=X, y=Y, **kw):
    kw.setdefault("pop_size", 16)
    jp = jeng.Problem.from_data(JTopo(sizes), x, y, JCfg(**kw), baseline_acc=0.9)
    tp = engine.Problem.from_data(MLPTopology(sizes), x, y, GAConfig(**kw),
                                  baseline_acc=0.9, device="cpu")
    return jp, tp


# -- the delta table ----------------------------------------------------------

F32_EDGES = [float(np.nextafter(np.float32(v), np.float32(d)))
             for v, d in ((0.2, 1), (0.2, 0), (0.5, 1), (1.0, 0))]


@pytest.mark.parametrize("scale", [0.0, 1.0, 0.2, 0.5, 0.05, *F32_EDGES])
@pytest.mark.parametrize("K,device_seed", [(8, 0), (6, 3), (1, 0)])
def test_device_deltas_match_reference(scale, K, device_seed):
    jp, tp = _problems((10, 3, 2), variation_mode="mean", n_device_samples=K,
                       device_seed=device_seed, variation_scale=scale)
    want = np.asarray(jeng.device_deltas(jp))
    got = engine.device_deltas(tp)
    assert got.dtype == torch.int32 and tuple(got.shape) == (K, tp.spec.n_genes)
    assert_bits_equal(want, got, f"scale {scale!r}")
    assert (got[0] == 0).all()
    assert set(np.unique(got.numpy())) <= {-1, 0, 1}
    live = tp.spec.is_exp & tp.genes.valid.numpy()
    assert (got.numpy()[:, ~live] == 0).all()
    if scale == 0.0:
        assert (got == 0).all()


def test_device_deltas_keyed_by_device_seed_not_run_seed():
    a = engine.device_deltas(_problems(variation_mode="mean", seed=0)[1])
    b = engine.device_deltas(_problems(variation_mode="mean", seed=123)[1])
    assert torch.equal(a, b)
    c = engine.device_deltas(_problems(variation_mode="mean", device_seed=9)[1])
    assert not torch.equal(a, c)
    # the swept scale is a () float32 leaf, as in the reference
    jp, tp = _problems(variation_mode="mean", variation_scale=0.25)
    assert_bits_equal(jeng.device_deltas(jp.with_hypers(variation_scale=jnp.float32(0.7))),
                      engine.device_deltas(tp.with_hypers(variation_scale=0.7)), "swept")


def test_apply_device_deltas_clips_per_gene():
    high = np.asarray([4, 8, 2], np.int32)
    pop = np.asarray([[3, 7, 0], [0, 0, 1], [9, 9, 9]], np.int32)
    rng = np.random.default_rng(0)
    for deltas in ([[1, 1, -1], [-1, -1, 1], [0, 0, 0]],
                   rng.integers(-1, 2, (3, 3))):
        d = np.asarray(deltas, np.int32)
        want = np.asarray(jg.apply_device_deltas(jnp.asarray(pop), jnp.asarray(d),
                                                 jnp.asarray(high)))
        got = tg.apply_device_deltas(torch.as_tensor(pop), torch.as_tensor(d),
                                     torch.as_tensor(high))
        assert_bits_equal(want, got, f"deltas {d.tolist()}")
    # a zero delta passes even an out-of-range gene through untouched
    got = tg.apply_device_deltas(torch.as_tensor(pop[2:]), torch.zeros(3, dtype=torch.int32),
                                 torch.as_tensor(high))
    assert got.tolist() == [[9, 9, 9]]


# -- the (P, K) fitness ---------------------------------------------------------

def _mc_case(sizes, P, S, K, seed):
    """Random population, quantized inputs, labels and a device_deltas
    table (scale 0.5) for one topology, in both packages."""
    spec_t = tg.GenomeSpec(tg.MLPTopology(sizes))
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec_t.low, spec_t.high, (P, spec_t.n_genes)).astype(np.int32)
    x01 = rng.random((S, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], S).astype(np.int32)
    jp, tp = _problems(sizes, x01, y, variation_mode="mean", n_device_samples=K,
                       variation_scale=0.5, device_seed=seed)
    dev = engine.device_deltas(tp)
    assert_bits_equal(jeng.device_deltas(jp), dev, "deltas")
    return jp.spec, tp.spec, pop, x01, y, dev


@pytest.mark.parametrize("sizes,K", [((6, 4, 2), 4), ((10, 3, 2), 6), ((5, 4, 3, 2), 1)])
def test_mc_fitness_matches_reference_ref_and_interpret(sizes, K):
    spec_j, spec_t, pop, x01, y, dev = _mc_case(sizes, P=12, S=70, K=K, seed=len(sizes) + K)
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    jargs = (jnp.asarray(pop), xj, jnp.asarray(y))
    targs = (torch.as_tensor(pop), xt, torch.as_tensor(y))
    jkw = dict(spec=spec_j, dev=jnp.asarray(dev.numpy()),
               gene_high=jnp.asarray(spec_t.high), pop_tile=5, sample_tile=32)
    want = np.asarray(j_correct(*jargs, backend="ref", **jkw))
    assert want.shape == (12, K)
    assert_bits_equal(want, np.asarray(j_correct(*jargs, backend="interpret", **jkw)),
                      "reference ref vs interpret")
    high = torch.as_tensor(spec_t.high)
    got = population_correct(*targs, spec=spec_t, backend="ref", dev=dev, gene_high=high,
                             pop_tile=5, sample_tile=32)
    assert_bits_equal(want, got, "ref")
    assert_bits_equal(want, population_correct(*targs, spec=spec_t, dev=dev,
                                               gene_high=high), "auto")
    # column 0 is the nominal count
    assert torch.equal(got[:, 0], population_correct(*targs, spec=spec_t))


def test_mc_kernel_plain_version_matches_interpret_kernel():
    """K4's plain version (what its wrapper runs on a CPU tensor) against
    the reference Pallas kernel in interpret mode, with a partial row
    bound, a sample bound over −1-labelled padding and an output-column
    mask. Rows past the bound are 0 in every column in the port."""
    sizes, K = (6, 4, 3), 6
    spec_j, spec_t, pop, x01, y, dev = _mc_case(sizes, P=16, S=200, K=K, seed=5)
    n_samp = 150
    y[n_samp:] = -1
    om = np.array([1, 1, 0], np.int32)
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    for rows in (16, 11, 0):
        ref = np.asarray(j_correct(
            jnp.asarray(pop), xj, jnp.asarray(y), spec=spec_j, backend="interpret",
            n_valid_rows=jnp.int32(rows), n_valid_samples=jnp.int32(n_samp),
            out_mask=jnp.asarray(om), dev=jnp.asarray(dev.numpy()),
            gene_high=jnp.asarray(spec_t.high)))
        kw = dict(spec=spec_t, n_valid_rows=torch.tensor(rows, dtype=torch.int32),
                  n_valid_samples=torch.tensor(n_samp, dtype=torch.int32),
                  out_mask=torch.as_tensor(om))
        args = (torch.as_tensor(pop), xt, torch.as_tensor(y))
        high = torch.as_tensor(spec_t.high)
        port = pop_mlp_correct_mc(*args, dev, high, **kw)          # CPU → plain
        assert torch.equal(port, pop_mlp_correct_mc_plain(*args, dev=dev, gene_high=high,
                                                          **kw))
        assert_bits_equal(ref[:rows], port[:rows], f"rows {rows}")
        assert (port[rows:] == 0).all()


def test_mc_fitness_requires_gene_high_and_rejects_jnp():
    spec = tg.GenomeSpec(tg.MLPTopology(TOPO))
    pop = tg.random_population(prng.PRNGKey(3), spec.table(), 4)
    x = tq.quantize_inputs(torch.as_tensor(X), 4)
    y = torch.as_tensor(Y)
    dev = torch.zeros((2, spec.n_genes), dtype=torch.int32)
    with pytest.raises(ValueError, match="gene_high"):
        population_correct(pop, x, y, spec=spec, backend="ref", dev=dev)
    with pytest.raises(ValueError, match="jnp"):
        population_correct(pop, x, y, spec=spec, backend="jnp", dev=dev,
                           gene_high=torch.as_tensor(spec.high))
    with pytest.raises(RuntimeError, match="CUDA"):
        population_correct(pop, x, y, spec=spec, backend="kernel", dev=dev,
                           gene_high=torch.as_tensor(spec.high))


# -- K4's arithmetic on the CPU (ref.pop_mlp_correct_mc_tables) -------------------

# breast_cancer's and cardio's topologies (padded into the compiled widths of
# pendigits and of the suite), pendigits' and the suite's padded one, and one
# that only the general kernel runs
MC_TABLE_TOPOS = [(10, 3, 2), (21, 3, 3), (16, 5, 10), (21, 5, 10), (5, 4, 3, 2)]


def _edge_case(sizes, K, P=10, S=150, seed=0):
    """A population whose exponent genes sit at 0 (every third row) and at
    max_exp (the next), one exponent at 33 and one at −2 (shl's zero) in
    row 2, and deltas that push them past both ends: row 0 zero (the
    nominal device), row 1 −1 and row 2 +1 on every exponent gene, the rest
    random in {−1, 0, +1} on them."""
    spec = tg.GenomeSpec(tg.MLPTopology(sizes))
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec.low, spec.high, (P, spec.n_genes)).astype(np.int32)
    pop[0::3, spec.is_exp] = 0
    pop[1::3, spec.is_exp] = spec.topo.max_exp
    exps = np.flatnonzero(spec.is_exp)
    pop[2, exps[0]], pop[2, exps[-1]] = 33, -2
    dev = rng.integers(-1, 2, (K, spec.n_genes)).astype(np.int32)
    dev[1:2], dev[2:3] = -1, 1
    dev = dev * spec.is_exp
    dev[0] = 0
    x01 = rng.random((S, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], S).astype(np.int32)
    return spec, pop, dev, x01, y


@pytest.mark.parametrize("K", [1, 13])
@pytest.mark.parametrize("sizes", MC_TABLE_TOPOS)
def test_mc_tables_arithmetic_matches_interpret_kernel(sizes, K):
    """K4's decomposition (per-(chromosome, instance) signed multipliers,
    shifted biases and right shifts, read through the compiled widths'
    padded table layout and through the general kernel's packed one; layer
    1's ``x & mask`` shared by the instances) against the reference Pallas
    kernel in interpret mode, bit for bit, with row and sample bounds and a
    masked output column. The kernel holds the tables of every instance at
    once, so K = 13 is as much one block's work as K = 1."""
    spec_t, pop, dev, x01, y = _edge_case(sizes, K, seed=sum(sizes) + K)
    spec_j = jg.GenomeSpec(jg.MLPTopology(sizes))
    n_samp = 120
    y[n_samp:] = -1
    om = np.ones(sizes[-1], np.int32)
    om[-1] = 0
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    for rows in (10, 7):
        ref = np.asarray(j_correct(
            jnp.asarray(pop), xj, jnp.asarray(y), spec=spec_j, backend="interpret",
            n_valid_rows=jnp.int32(rows), n_valid_samples=jnp.int32(n_samp),
            out_mask=jnp.asarray(om), dev=jnp.asarray(dev), gene_high=jnp.asarray(spec_t.high)))
        for packed in (False, True):
            got = pop_mlp_correct_mc_tables(
                torch.as_tensor(pop), xt, torch.as_tensor(y), spec=spec_t,
                dev=torch.as_tensor(dev), gene_high=torch.as_tensor(spec_t.high),
                n_valid_rows=rows, n_valid_samples=n_samp, out_mask=torch.as_tensor(om),
                packed=packed)
            assert got.dtype == torch.int32 and tuple(got.shape) == (10, K)
            assert_bits_equal(ref[:rows], got[:rows], f"rows {rows}, packed {packed}")
            assert (got[rows:] == 0).all()


@pytest.mark.parametrize("sizes", MC_TABLE_TOPOS)
def test_k1_tables_arithmetic_matches_interpret_kernel(sizes):
    """K1's arithmetic: the tables of the nominal device (one instance, no
    deltas: ``dev`` None, as K1's kernel compiles the deltas out), read
    through the compiled widths' padded layout and the general kernel's
    packed one, against the reference Pallas ``pop_mlp_correct`` in
    interpret mode, bit for bit, with a row bound, a sample bound over
    −1-labelled padding and a masked output column; exponents at 0, at
    max_exp, and at 33 and −2 (shl's zero)."""
    spec_t, pop, _, x01, y = _edge_case(sizes, 1, seed=sum(sizes) + 100)
    spec_j = jg.GenomeSpec(jg.MLPTopology(sizes))
    n_samp, rows = 120, 7
    y[n_samp:] = -1
    om = np.ones(sizes[-1], np.int32)
    om[-1] = 0
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    ref = np.asarray(j_correct(
        jnp.asarray(pop), xj, jnp.asarray(y), spec=spec_j, backend="interpret",
        n_valid_rows=jnp.int32(rows), n_valid_samples=jnp.int32(n_samp),
        out_mask=jnp.asarray(om)))
    assert ref.shape == (10,)
    for packed in (False, True):
        got = pop_mlp_correct_mc_tables(
            torch.as_tensor(pop), xt, torch.as_tensor(y), spec=spec_t, n_valid_rows=rows,
            n_valid_samples=n_samp, out_mask=torch.as_tensor(om), packed=packed)
        assert got.dtype == torch.int32 and tuple(got.shape) == (10, 1)
        assert_bits_equal(ref[:rows], got[:rows, 0], f"packed {packed}")
        assert (got[rows:] == 0).all()


def test_mc_tables_hold_the_clipped_signed_multipliers():
    """The tables themselves at pendigits (compiled widths: each layer
    padded to 4 words) and the general kernel's packed layout."""
    spec, pop, dev, _, _ = _edge_case((16, 5, 10), 3)
    pop[:, spec.is_exp] = [[0], [6], [3], [0], [6], [3], [0], [6], [3], [0]]
    pop[:, spec.layers[0].signs.start] = 0   # a weight of sign -1 in every row
    mult, mask, bias, rsh = mc_tables(torch.as_tensor(pop), torch.as_tensor(dev),
                                      torch.as_tensor(spec.high), spec=spec)
    lay = mc_layout((16, 5, 10))
    assert (lay.wp, lay.np, lay.woff, lay.noff) == (132, 20, (0, 80), (0, 8))
    assert tuple(mult.shape) == (10, 3, 132) and tuple(bias.shape) == (10, 20)
    signs = torch.as_tensor(pop[:, spec.layers[0].signs] * 2 - 1)
    # instance 0 leaves the exponent, instance 1 moves it down, instance 2 up,
    # each clipped into [0, 6]
    for row, want in ((0, (0, 0, 1)), (1, (6, 5, 6)), (2, (3, 2, 4))):
        for k, e in enumerate(want):
            got = mult[row, k, :80] - ((mult[row, k, :80] >> 31) << 32)
            assert torch.equal(got, signs[row].long() << e), (row, k)
    assert (mult[:, :, 130:] == 0).all() and (mask[:, 130:] == 0).all()
    assert torch.equal(mask[:, :80], torch.as_tensor(pop[:, spec.layers[0].masks]).long())
    g = pop[0]
    for l, sl in enumerate(spec.layers):
        want = (g[sl.biases].astype(np.int64) << g[sl.bshift.start]) & 0xFFFFFFFF
        assert bias[0, lay.noff[l]:lay.noff[l] + sl.fan_out].tolist() == want.tolist()
        assert int(rsh[0, l]) == g[sl.rshift.start]
    general = mc_layout((6, 4, 3), packed=True)
    assert (general.wp, general.np, general.woff, general.noff) == (36, 7, (0, 24), (0, 4))


def test_mc_tables_padded_into_compiled_widths():
    """breast_cancer's (10, 3, 2) laid out in pendigits' compiled widths:
    the same layout, each weight at its (input, neuron) slot with the value
    the packed tables hold, every slot past the net's widths 0."""
    spec, pop, dev, _, _ = _edge_case((10, 3, 2), 4)
    args = (torch.as_tensor(pop), torch.as_tensor(dev), torch.as_tensor(spec.high))
    assert mc_layout((10, 3, 2)) == mc_layout((16, 5, 10))
    pad, packed = mc_tables(*args, spec=spec), mc_tables(*args, spec=spec, packed=True)
    lay, own = mc_layout((10, 3, 2)), mc_layout((10, 3, 2), packed=True)
    for l, (fi, fo) in enumerate(((10, 3), (3, 2))):
        for t_pad, t_own in ((pad[0], packed[0]), (pad[1][:, None], packed[1][:, None])):
            slots = t_pad[..., lay.woff[l]:lay.woff[l] + lay.fi[l] * lay.fo[l]].unflatten(
                -1, (lay.fi[l], lay.fo[l]))
            assert torch.equal(slots[..., :fi, :fo], t_own[..., own.woff[l]:own.woff[l] + fi * fo]
                               .unflatten(-1, (fi, fo)))
            slots[..., :fi, :fo] = 0
            assert (slots == 0).all()
        b = pad[2][:, lay.noff[l]:lay.noff[l] + lay.fo[l]]
        assert torch.equal(b[:, :fo], packed[2][:, own.noff[l]:own.noff[l] + fo])
        assert (b[:, fo:] == 0).all()
    assert torch.equal(pad[3], packed[3])


CSRC = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"


def test_mc_buckets_match_the_kernel_source():
    """The compiled widths listed here are those the table kernels compile
    (``csrc/common.cuh``, which ``pop_mlp.cu`` and ``pop_generation.cu``
    share), and each of the paper's topologies and the suite's pads into
    the smallest that holds it."""
    src = (CSRC / "common.cuh").read_text()
    line = re.search(r"constexpr McDims kMcBuckets\[\] = \{(.*)\};", src).group(1)
    assert tuple(tuple(map(int, b)) for b in re.findall(r"\{(\d+), (\d+), (\d+)\}", line)) \
        == MC_BUCKETS
    assert [mc_bucket(s) for s in ((16, 5, 10), (10, 3, 2), (11, 2, 6), (11, 4, 7), (6, 4, 3))] \
        == [(16, 5, 10)] * 5
    assert [mc_bucket(s) for s in ((21, 5, 10), (21, 3, 3), (17, 1, 1))] == [(21, 5, 10)] * 3
    assert [mc_bucket(s) for s in ((22, 5, 10), (16, 6, 10), (16, 5, 11), (5, 4, 3, 2))] \
        == [None] * 4


def test_mc_tiles_match_the_kernel_source():
    """Each table kernel's tile listed here (chromosomes per block, samples
    per thread, blocks per SM), which the shared-memory mirrors use, is the
    one ``csrc/common.cuh`` compiles."""
    src = (CSRC / "common.cuh").read_text()
    for name, tile in MC_TILES.items():
        m = re.search(rf"constexpr int k{name}Rows = (\d+), k{name}Samples = (\d+), "
                      rf"k{name}BlocksPerSM = (\d+);", src)
        assert m is not None, name
        assert tuple(map(int, m.groups())) == tile, name
    assert MC_TILES["K3"][0] % 2 == 0 and MC_TILES["K3N"][0] % 2 == 0   # whole pairs


def test_mc_smem_never_exceeds_the_earlier_layout():
    """The table kernels' packed tables (their general kernel's) never need
    more shared memory than the layouts they replace, at any K, for the
    compiled widths, edge topologies and 300 random ones of up to 4 layers
    of width up to 32: K4's and K3 ``n_dev``'s (its children's tile ahead of
    the tables) against the layout both ran on before (a genome tile of 8
    rows, the delta table, the gene bounds, the output mask and 8 rows of
    counts), K1's against its genome tile of 8 rows; the compiled widths'
    padded tables run only where they fit. So every K that launched before
    still launches on an H100. K = 200 at pendigits is still past K4's
    232,448 bytes a block."""
    def old_mc(G, K):   # the earlier layout of K4 and K3's n_dev branch, in bytes
        return 4 * (8 * G + K * G + G + 32 + 8 * K)

    def old_k1(G):      # K1's earlier genome tile, output mask and counts
        return 4 * (8 * G + 32 + 8)

    rng = np.random.default_rng(0)
    topos = list(MC_BUCKETS) + [(10, 3, 2), (21, 3, 3), (11, 2, 6), (11, 4, 7), (1, 1),
                                (32, 1), (3, 2), (32, 32), (32, 32, 32, 32, 32), (6, 4, 3),
                                (5, 4, 3, 2)]
    topos += [tuple(int(w) for w in rng.integers(1, 33, rng.integers(2, 6)))
              for _ in range(300)]
    for sizes in topos:
        G = tg.GenomeSpec(tg.MLPTopology(sizes)).n_genes
        for K in (1, 2, 3, 8, 13, 50, 130, 200, 456, 1000, 5000):
            old = old_mc(G, K)
            for name, packed, card in (
                    ("K4", mc_smem_bytes(sizes, K, limit=0), mc_smem_bytes(sizes, K)),
                    ("K3 n_dev", generation_mc_smem_bytes(sizes, G, K, limit=0),
                     generation_mc_smem_bytes(sizes, G, K))):
                assert packed <= old, (name, sizes, K)
                assert old > H100_SMEM_OPTIN or card <= H100_SMEM_OPTIN, (name, sizes, K)
        assert k1_smem_bytes(sizes, limit=0) <= old_k1(G), sizes
        assert k1_smem_bytes(sizes) <= H100_SMEM_OPTIN, sizes
    assert mc_smem_bytes((16, 5, 10), 200) > 232448 >= mc_smem_bytes((16, 5, 10), 130)


@pytest.mark.parametrize("K", [1, 6])
def test_generation_kernel_n_dev_plain_matches_interpret_kernel(K):
    """K3's n_dev branch on its plain path and by its kernel's table
    arithmetic (the K2 plain version's children through
    ``pop_mlp_correct_mc_tables``, padded and packed) against the reference
    megakernel in interpret mode with the same deltas: the children equal
    the nominal branch's, the counts are (P, K)."""
    sizes = (6, 4, 3)
    spec_j, spec_t, pop, x01, y, dev = _mc_case(sizes, P=20, S=150, K=K, seed=11)
    P = 10
    t = spec_t.table()
    rng = np.random.default_rng(K)
    do = rng.random(P) < 0.7
    key = prng.PRNGKey(21)
    keys = tg._slot_keys(key, (0, 1, 2))
    pm = 0.3
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    tj = spec_j.table()
    ch_j, cnt_j = j_gen_kernel(
        jnp.asarray(pop[:P]), jnp.asarray(pop[P:]), jnp.asarray(do), tj.low, tj.high,
        tj.is_mask, tj.mask_bits, tj.ids, jnp.asarray(keys.numpy().astype(np.uint32)),
        jnp.float32(pm), xj, jnp.asarray(y), spec=spec_j, interpret=True,
        dev=jnp.asarray(dev.numpy()))
    args = (torch.as_tensor(pop[:P]), torch.as_tensor(pop[P:]), torch.as_tensor(do),
            t.low, t.high, t.is_mask, t.mask_bits, t.ids, keys,
            torch.tensor(pm, dtype=torch.float32), xt, torch.as_tensor(y))
    ch_t, cnt_t = pop_generation_kernel(*args, spec=spec_t, dev=dev)   # CPU → plain
    assert tuple(cnt_t.shape) == (P, K)
    assert_bits_equal(ch_j, ch_t, "children")
    assert_bits_equal(cnt_j, cnt_t, "counts")
    ch_n, cnt_n = pop_generation_plain(*args, spec=spec_t)
    assert torch.equal(ch_n, ch_t) and torch.equal(cnt_n, cnt_t[:, 0])
    # K3 n_dev's arithmetic: the K2 plain version's children through the tables
    # of their K instances (the kernel's tile is one pair; P / 2 = 5 is odd, so
    # rows 4 and 5 draw their swaps from two Threefry counters)
    children = pop_variation_plain(*args[:10])
    assert_bits_equal(ch_j, children, "K2's children")
    for packed in (False, True):
        got = pop_mlp_correct_mc_tables(children, xt, torch.as_tensor(y), spec=spec_t, dev=dev,
                                        gene_high=t.high, packed=packed)
        assert_bits_equal(cnt_j, got, f"tables, packed {packed}")


# -- the float32 order of the robust objective ---------------------------------

@pytest.mark.parametrize("mode", ["mean", "worst"])
@pytest.mark.parametrize("K", [1, 2, 4, 6, 8, 12])
def test_robust_objectives_match_the_jitted_reference(mode, K):
    """Many random (N, K) counts (with low accuracies, where a float64
    difference would round before float32 does) through the reference's
    jitted ``objectives`` and the port's, bit for bit."""
    rng = np.random.default_rng(K)
    S = 7696
    x01 = rng.random((S, 10)).astype(np.float32)
    y = rng.integers(0, 2, S).astype(np.int32)
    jp, tp = _problems((10, 3, 2), x01, y, variation_mode=mode, n_device_samples=K,
                       max_acc_loss=0.05)
    N = 4096
    counts = rng.integers(0, S + 1, (N, K)).astype(np.int32)
    counts[: N // 4] = rng.integers(0, S // 40, (N // 4, K))
    pop = rng.integers(tp.spec.low, tp.spec.high, (N, tp.spec.n_genes)).astype(np.int32)
    f = jax.jit(lambda p, g, c: jeng.objectives(p, g, jeng.counts_accuracy(p, c)))
    jo, jv = f(jp, jnp.asarray(pop), jnp.asarray(counts))
    to, tv = engine.objectives(tp, torch.as_tensor(pop),
                               engine.counts_accuracy(tp, torch.as_tensor(counts)))
    assert tuple(to.shape) == (N, 3)
    assert_bits_equal(jo, to, f"{mode} K={K} obj")
    assert_bits_equal(jv, tv, f"{mode} K={K} viol")


# -- one generation across the packages ------------------------------------------

_j_init = jax.jit(jeng.init_state)
_j_gen = jax.jit(j_gen, static_argnames="backend")


@pytest.mark.parametrize("mode", ["mean", "worst"])
def test_one_mc_generation_from_the_reference_state(bc_dataset, mode, monkeypatch):
    """A reference MC state ((P, K) counts, (cap, K) cache values) carried
    into the port drives each generation backend to the reference's next
    state, and the port's init equals the reference's."""
    kernel_paths_on_cpu(monkeypatch)
    ds = bc_dataset
    jp, tp = _problems(ds.topology, ds.x_train, ds.y_train, variation_mode=mode,
                       n_device_samples=6, variation_scale=0.4, seed=4)
    j0, jn = _j_init(jp, jax.random.PRNGKey(3))
    t0, tn = engine.init_state(tp, prng.PRNGKey(3))
    assert tuple(t0.counts.shape) == (16, 6) and tuple(t0.cache.vals.shape[1:]) == (6,)
    assert_states_equal(j0, t0, msg="init")
    assert int(jn) == int(tn)
    carried = state_from_numpy(jax_leaves(j0), device="cpu")
    assert_states_equal(j0, carried, msg="carried")
    for backend, jb in (("ref", "ref"), ("phases", "phases"), ("kernel", "interpret")):
        j1, jaux = _j_gen(jp, j0, backend=jb)
        t1, taux = population_generation(tp, carried, backend=backend)
        assert_states_equal(j1, t1, msg=f"{mode}/{backend}")
        for k, (a, b) in enumerate(zip(jaux, taux)):
            assert_bits_equal(a, b, f"{backend} aux[{k}]")


# -- whole runs --------------------------------------------------------------------

BACKENDS = ("kernel", "phases", "ref")
DEDUPS = (False, "legacy", True)
# mean at a K whose reciprocal rounds; worst at the default K = 8, scale 0.2
MODES = {"mean": dict(n_device_samples=6, variation_scale=0.4),
         "worst": dict()}
RUN = dict(pop_size=16, generations=3, seed=2)


def _run_kw(mode, dedup):
    return dict(RUN, dedup=dedup, variation_mode=mode, **MODES[mode])


# The reference holds its generation backends bit-identical
# (src/repro/kernels/pop_generation/ops.py, tests/test_generation_path.py):
# "ref" and "phases" run the same code but in the cache dedup mode, where
# "ref" updates the EvalCache and "phases" carries it through, as the kernel
# path does; the kernel path's accounting is every child evaluated (P a
# generation, no hits) after the same init. So one reference run per (mode,
# dedup, reference backend) serves every port backend it pins, compiled
# once per process.
_REFERENCE_RUNS: dict = {}


def _reference_run(ds, mode, dedup, backend):
    """(reference trainer, final state) for the port's ``backend``."""
    jb = "phases" if dedup is True and backend != "ref" else "ref"
    key = (mode, dedup, jb)
    if key not in _REFERENCE_RUNS:
        jt = JTrainer(JTopo(ds.topology), ds.x_train, ds.y_train,
                      JCfg(**_run_kw(mode, dedup), generation_backend=jb))
        _REFERENCE_RUNS[key] = (jt, jt.run()[0])
    return _REFERENCE_RUNS[key]


@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_trainer_mc_run_matches_reference(bc_dataset, mode, backend, dedup, monkeypatch):
    kernel_paths_on_cpu(monkeypatch)
    ds = bc_dataset
    jt, js = _reference_run(ds, mode, dedup, backend)
    if backend == "kernel":
        want = (jt._init_unique_evals + RUN["generations"] * RUN["pop_size"], 0)
    else:
        want = (jt.unique_evals, jt.cache_hits)
    tcfg = GAConfig(**_run_kw(mode, dedup), backends=BackendPolicy(generation=backend))
    tt = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train, tcfg, device="cpu")
    ts, history = tt.run(verbose=True)
    assert [h["gen"] for h in history] == [0, RUN["generations"] - 1]
    K = tcfg.n_device_samples
    assert tuple(ts.obj.shape) == (16, 3) and tuple(ts.counts.shape) == (16, K)
    assert_states_equal(js, ts, msg=f"{mode}/{backend}/{dedup}")
    assert (tt.unique_evals, tt.cache_hits) == want
    jf, tf = jt.front(js), tt.front(ts)
    assert tf["objectives"].shape[1] == 3
    for k in ("objectives", "indices", "genomes"):
        assert_bits_equal(jf[k], tf[k], f"front {k}")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mc_dedup_modes_agree(bc_dataset, mode):
    """Dedup off / legacy / cache give identical MC states (counts are zero
    with dedup off by design)."""
    ds = bc_dataset
    runs = {}
    for d in DEDUPS:
        tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                       GAConfig(**_run_kw(mode, d)), device="cpu")
        runs[d] = state_to_numpy(tr.run()[0])
    for name in NO_COUNTS:
        assert_bits_equal(runs[False][name], runs["legacy"][name], f"off/legacy {name}")
        assert_bits_equal(runs["legacy"][name], runs[True][name], f"legacy/cache {name}")
    assert_bits_equal(runs["legacy"]["counts"], runs[True]["counts"], "counts")
    assert (runs[False]["counts"] == 0).all()


def test_variation_off_is_two_objective():
    tr = GATrainer(MLPTopology(TOPO), X, Y, GAConfig(pop_size=16, generations=2),
                   baseline_acc=0.9, device="cpu")
    st, _ = tr.run()
    assert tuple(st.obj.shape) == (16, 2) and tuple(st.counts.shape) == (16,)
    assert tuple(st.cache.vals.shape) == (4096,)


def test_gaconfig_variation_validation():
    with pytest.raises(ValueError, match="variation_mode"):
        GAConfig(variation_mode="avg")
    with pytest.raises(ValueError, match="n_device_samples"):
        GAConfig(variation_mode="mean", n_device_samples=0)
    with pytest.raises(ValueError, match="variation_scale"):
        GAConfig(variation_mode="mean", variation_scale=1.5)
    with pytest.raises(ValueError, match="variation_scale"):
        GAConfig(variation_scale=-0.1)
    with pytest.raises(ValueError, match="jnp"):
        GAConfig(variation_mode="mean", backends=BackendPolicy(fitness="jnp"))
    GAConfig(variation_mode="worst", n_device_samples=1, variation_scale=1.0)
