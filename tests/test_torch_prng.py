"""The port's counter-based RNG against jax 0.9.0's: keys, split, uniform,
randint, the gene-addressed Threefry draws and the random population, bit
for bit (tolerance 0), plus an exhaustive check of the float rounding of
the mutation reset and init draws at every gene range of the repo."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import genome as jg
from repro_torch.core import genome as tg
from repro_torch.core import prng
from test_torch_interop import assert_bits_equal

SEEDS = [0, 1, 7, 12345, 2**31 - 1, -1, -99]


def test_threefry_partitionable_flag_is_what_the_port_copied():
    """The port copies jax 0.9.0's partitionable Threefry streams; if the
    flag flips, split/uniform/randint change and the port must follow."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_uniform_randint(seed):
    k, t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert_bits_equal(np.asarray(k).astype(np.int64), t, "PRNGKey")
    for n in (1, 2, 3, 5):
        assert_bits_equal(np.asarray(jax.random.split(k, n)).astype(np.int64),
                          prng.split(t, n), f"split {n}")
    for shape in [(1,), (7,), (8, 1), (3, 5)]:
        assert_bits_equal(jax.random.uniform(k, shape), prng.uniform(t, shape),
                          f"uniform {shape}")
    for shape, hi in [((16, 2), 16), ((9, 2), 33), ((256, 2), 256), ((5,), 1000)]:
        assert_bits_equal(jax.random.randint(k, shape, 0, hi),
                          prng.randint(t, shape, 0, hi), f"randint {shape} {hi}")


def test_uniform_shapes_n_and_n_by_1_draw_the_same_bits():
    """The reference draws the crossover gate at (P/2,) in the generation
    kernel path and at (P/2, 1) in the variation path: both are the same
    bits, in jax and in the port."""
    for seed in (0, 3):
        k, t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        a = np.asarray(jax.random.uniform(k, (8,)))
        b = np.asarray(jax.random.uniform(k, (8, 1)))[:, 0]
        assert_bits_equal(a, b, "jax (n,) vs (n, 1)")
        assert_bits_equal(a, prng.uniform(t, (8,)), "port (n,)")
        assert_bits_equal(a, prng.uniform(t, (8, 1))[:, 0], "port (n, 1)")


def test_threefry2x32_matches_reference_on_random_words():
    rng = np.random.default_rng(0)
    w = rng.integers(0, 2**32, (4, 257), dtype=np.uint64)
    ref = jg.threefry2x32(*(jnp.asarray(x.astype(np.uint32)) for x in w))
    port = tg.threefry2x32(*(torch.as_tensor(x.astype(np.int64)) for x in w))
    for r, p in zip(ref, port):
        assert_bits_equal(np.asarray(r).astype(np.int64), p, "threefry")


@pytest.mark.parametrize("n", [1, 6, 7, 16])
def test_gene_uniform_slots_and_random_population(n):
    spec_j = jg.GenomeSpec(jg.MLPTopology((5, 4, 3)))
    spec_t = tg.GenomeSpec(tg.MLPTopology((5, 4, 3)))
    for seed in (0, 11):
        k, t = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        ids_j, ids_t = spec_j.gene_ids, torch.as_tensor(spec_t.gene_ids)
        assert_bits_equal(jg.gene_uniform_slots(k, ids_j, n, 3),
                          tg.gene_uniform_slots(t, ids_t, n, 3), "slots")
        assert_bits_equal(jg.gene_uniform(k, ids_j, n, slot=2),
                          tg.gene_uniform(t, ids_t, n, slot=2), "slot 2")
        assert_bits_equal(jax.jit(jg.random_population, static_argnums=2)(
                              k, spec_j.table(), n),
                          tg.random_population(t, spec_t.table(), n), "population")


def test_gene_uniform_draws_are_id_addressed():
    """Shuffled ids give the same draw per id (gene-axis independence)."""
    t = prng.PRNGKey(5)
    ids = torch.arange(20, dtype=torch.int32)
    perm = torch.randperm(20, generator=torch.Generator().manual_seed(0))
    a = tg.gene_uniform(t, ids, 9)
    b = tg.gene_uniform(t, ids[perm], 9)
    assert torch.equal(a[:, perm], b)


# every (low, high) gene range of the repo's layouts: 4-/8-bit masks,
# signs, exponents and bias/rshift shifts, and the 8-bit signed biases
GENE_RANGES = [(0, 2), (0, 7), (0, 8), (0, 16), (0, 256), (-128, 128)]


def test_reset_floor_is_exact_for_every_u_at_every_gene_range():
    """``floor(lo + u * (hi - lo))``: XLA may contract it into an FMA under
    jit, the port rounds the product and the sum separately. Over all 2**23
    possible uniforms and every gene range the floors agree; so do the
    mask bit positions ``floor(u * bits)``."""
    u_np = (np.arange(2**23, dtype=np.float64) * 2.0**-23).astype(np.float32)
    u_t = torch.as_tensor(u_np)
    reset = jax.jit(lambda u, lo, hi: jnp.floor(lo + u * (hi - lo)).astype(jnp.int32))
    bitpos = jax.jit(lambda u, b: jnp.floor(u * b).astype(jnp.int32))
    for lo, hi in GENE_RANGES:
        ref = np.asarray(reset(u_np, np.float32(lo), np.float32(hi)))
        lo_t = torch.tensor(float(lo), dtype=torch.float32)
        hi_t = torch.tensor(float(hi), dtype=torch.float32)
        port = torch.floor(lo_t + u_t * (hi_t - lo_t)).to(torch.int32)
        np.testing.assert_array_equal(ref, port.numpy(), err_msg=f"[{lo}, {hi})")
    for b in (4, 8):
        ref = np.asarray(bitpos(u_np, np.float32(b)))
        port = torch.floor(u_t * torch.tensor(b, dtype=torch.int32)).to(torch.int32)
        np.testing.assert_array_equal(ref, port.numpy(), err_msg=f"bits {b}")
