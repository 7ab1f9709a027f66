"""K3's nominal branch on the tables of per-instance weight multipliers:
its arithmetic (the K2 plain version's children through
``pop_mlp_correct_mc_tables`` at one instance, the deltas left out, in the
compiled widths' padded layout and the general kernel's packed one) against
the reference megakernel in interpret mode, bit for bit, with a sample bound
and a masked output column; and its shared memory per block
(``ref.generation_smem_bytes``, the CPU mirror of the launcher's
``pop_generation_smem_bytes``) against the per-weight kernel's layout it
replaced, so every net that launched still launches. Tolerance 0."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import genome as jg, quantize as jq
from repro.kernels.pop_generation.kernel import pop_generation_kernel as j_gen_kernel
from repro_torch.core import genome as tg, prng, quantize as tq
from repro_torch.kernels.pop_generation import pop_generation_kernel, pop_generation_plain
from repro_torch.kernels.pop_mlp import ref
from repro_torch.kernels.pop_mlp.ref import (H100_SMEM_OPTIN, MC_BUCKETS,
                                             generation_smem_bytes, mc_layout,
                                             pop_mlp_correct_mc_tables)
from repro_torch.kernels.pop_variation import pop_variation_plain
from test_torch_interop import assert_bits_equal


# one net padded into pendigits' compiled widths, and a 3-layer one that only
# the general kernel runs (its padded and packed layouts are the same)
@pytest.mark.parametrize("sizes", [(6, 4, 3), (5, 4, 3, 2)])
def test_generation_kernel_nominal_tables_match_interpret_kernel(sizes):
    """The reference megakernel's nominal branch in interpret mode, P = 10
    children (P / 2 odd: rows 4 and 5 draw their swaps from two Threefry
    counters) over S = 150 samples of which 120 are counted (the rest
    labelled −1, as the engine pads), the last output column masked;
    parents whose exponents sit at 0 and at max_exp. The port's plain path
    gives the same children and counts, and so does the nominal kernel's
    table arithmetic on the K2 plain version's children."""
    spec_j, spec_t = jg.GenomeSpec(jg.MLPTopology(sizes)), tg.GenomeSpec(tg.MLPTopology(sizes))
    P, S, n_samp = 10, 150, 120
    rng = np.random.default_rng(sum(sizes))
    pop = rng.integers(spec_t.low, spec_t.high, (2 * P, spec_t.n_genes)).astype(np.int32)
    pop[0::3, spec_t.is_exp] = 0
    pop[1::3, spec_t.is_exp] = spec_t.topo.max_exp
    x01 = rng.random((S, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], S).astype(np.int32)
    y[n_samp:] = -1
    om = np.ones(sizes[-1], np.int32)
    om[-1] = 0
    do = rng.random(P) < 0.7
    keys = tg._slot_keys(prng.PRNGKey(sum(sizes)), (0, 1, 2))
    pm = 0.3
    tj = spec_j.table()
    ch_j, cnt_j = j_gen_kernel(
        jnp.asarray(pop[:P]), jnp.asarray(pop[P:]), jnp.asarray(do), tj.low, tj.high,
        tj.is_mask, tj.mask_bits, tj.ids, jnp.asarray(keys.numpy().astype(np.uint32)),
        jnp.float32(pm), jq.quantize_inputs(jnp.asarray(x01), 4), jnp.asarray(y),
        spec=spec_j, interpret=True, n_valid_samples=jnp.int32(n_samp),
        out_mask=jnp.asarray(om))
    assert np.asarray(cnt_j).shape == (P,)
    t = spec_t.table()
    xt, yt, omt = tq.quantize_inputs(torch.as_tensor(x01), 4), torch.as_tensor(y), \
        torch.as_tensor(om)
    args = (torch.as_tensor(pop[:P]), torch.as_tensor(pop[P:]), torch.as_tensor(do),
            t.low, t.high, t.is_mask, t.mask_bits, t.ids, keys,
            torch.tensor(pm, dtype=torch.float32))
    ch_t, cnt_t = pop_generation_kernel(*args, xt, yt, spec=spec_t, n_valid_samples=n_samp,
                                        out_mask=omt)   # CPU → plain
    assert_bits_equal(ch_j, ch_t, "children")
    assert_bits_equal(cnt_j, cnt_t, "counts")
    children = pop_variation_plain(*args)
    assert_bits_equal(ch_j, children, "K2's children")
    for packed in (False, True):
        got = pop_mlp_correct_mc_tables(children, xt, yt, spec=spec_t, n_valid_samples=n_samp,
                                        out_mask=omt, packed=packed)
        assert got.dtype == torch.int32 and tuple(got.shape) == (P, 1)
        assert_bits_equal(cnt_j, got[:, 0], f"tables, packed {packed}")
    ch_p, cnt_p = pop_generation_plain(*args, xt, yt, spec=spec_t, n_valid_samples=n_samp,
                                       out_mask=omt)
    assert torch.equal(ch_p, ch_t) and torch.equal(cnt_p, cnt_t)


@pytest.mark.parametrize("rows", [2, 4])
def test_generation_smem_never_exceeds_the_per_weight_layout(rows, monkeypatch):
    """K3 nominal's shared memory per block at a tile of 2 or 4 children
    (the rows ``scripts/mc_tiles.py`` may pick): its children's tile, then
    their tables at one instance, in the compiled widths' padded layout
    where it fits the card, else packed. The packed layout never needs more
    than the per-weight kernel's 4 (8 G + 32 + 8) bytes (8 genomes, the
    output mask, 8 counts) at the compiled widths, edge topologies and 300
    random ones of up to 4 layers of width up to 32, so every net that
    launched still launches on an H100."""
    monkeypatch.setitem(ref.MC_TILES, "K3N", (rows, 8, 4))
    rng = np.random.default_rng(rows)
    topos = list(MC_BUCKETS) + [(10, 3, 2), (21, 3, 3), (11, 2, 6), (11, 4, 7), (1, 1),
                                (32, 1), (3, 2), (32, 32), (32, 32, 32, 32, 32), (6, 4, 3),
                                (5, 4, 3, 2), (6, 7, 3)]
    topos += [tuple(int(w) for w in rng.integers(1, 33, rng.integers(2, 6)))
              for _ in range(300)]
    for sizes in topos:
        G = tg.GenomeSpec(tg.MLPTopology(sizes)).n_genes
        old = 4 * (8 * G + 32 + 8)
        assert generation_smem_bytes(sizes, G, limit=0) <= old, sizes
        assert old > H100_SMEM_OPTIN or generation_smem_bytes(sizes, G) <= H100_SMEM_OPTIN, sizes
    # pendigits: the children's tile (rows x 409 words, a multiple of 4), then
    # per child one multiplier block and one mask block of 132 words, 20 bias
    # words, 4 right shifts and 1 count, then the 32-word output mask
    lay = mc_layout((16, 5, 10))
    assert (lay.wp, lay.np) == (132, 20)
    tile = -(-rows * 409 // 4) * 4
    assert generation_smem_bytes((16, 5, 10), 409) == 4 * (tile + rows * (2 * 132 + 20 + 5) + 32)
