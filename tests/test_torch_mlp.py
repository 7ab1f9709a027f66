"""The port's integer forward pass and population fitness against the
reference: quantization, QReLU, forward logits, accuracy, the tiled and
oracle fitness paths and the plain version of the CUDA fitness kernel,
with row/sample bounds and output-column masks; tolerance 0."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import genome as jg, mlp as jmlp, quantize as jq
from repro.kernels.pop_mlp import population_correct as j_correct
from repro_torch.core import genome as tg, mlp as tmlp, quantize as tq
from repro_torch.core import prng
from repro_torch.kernels.pop_mlp import (population_correct, pop_mlp_correct,
                                         pop_mlp_correct_plain)
from test_torch_interop import assert_bits_equal

TOPOS = [(10, 3, 2), (6, 4, 3), (5, 4, 3, 2)]


def _case(sizes, P=12, S=70, seed=0):
    """Random in-bounds population, quantized inputs and labels (numpy)."""
    spec_j = jg.GenomeSpec(jg.MLPTopology(sizes))
    spec_t = tg.GenomeSpec(tg.MLPTopology(sizes))
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec_t.low, spec_t.high, (P, spec_t.n_genes)).astype(np.int32)
    x01 = rng.random((S, sizes[0])).astype(np.float32)
    y = rng.integers(0, sizes[-1], S).astype(np.int32)
    return spec_j, spec_t, pop, x01, y


def test_quantize_inputs_and_qrelu():
    rng = np.random.default_rng(1)
    x = rng.random((200, 7)).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5 / 15, 1.5 / 15]        # exact ties round to even
    for b in (4, 8):
        assert_bits_equal(jq.quantize_inputs(jnp.asarray(x), b),
                          tq.quantize_inputs(torch.as_tensor(x), b), f"bits {b}")
    acc = rng.integers(-3000, 3000, (50, 6)).astype(np.int32)
    sh = rng.integers(0, 8, (50, 1)).astype(np.int32)
    assert_bits_equal(jq.qrelu(jnp.asarray(acc), jnp.asarray(sh), 8),
                      tq.qrelu(torch.as_tensor(acc), torch.as_tensor(sh), 8), "qrelu")


@pytest.mark.parametrize("sizes", TOPOS)
def test_forward_accuracy_and_counts(sizes):
    spec_j, spec_t, pop, x01, y = _case(sizes)
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    for i in range(3):
        assert_bits_equal(jmlp.mlp_forward(spec_j, jnp.asarray(pop[i]), xj),
                          tmlp.mlp_forward(spec_t, torch.as_tensor(pop[i]), xt),
                          f"forward genome {i}")
    assert_bits_equal(jax.vmap(lambda g: jmlp.mlp_forward(spec_j, g, xj))(jnp.asarray(pop)),
                      tmlp.mlp_forward(spec_t, torch.as_tensor(pop), xt), "batched forward")
    assert_bits_equal(jax.jit(jmlp.population_accuracy, static_argnums=0)(
                          spec_j, jnp.asarray(pop), xj, jnp.asarray(y)),
                      tmlp.population_accuracy(spec_t, torch.as_tensor(pop), xt,
                                               torch.as_tensor(y)), "accuracy")
    om = np.ones(sizes[-1], np.int32)
    om[-1] = 0
    assert_bits_equal(jmlp.population_correct_counts(spec_j, jnp.asarray(pop), xj,
                                                     jnp.asarray(y), jnp.asarray(om)),
                      tmlp.population_correct_counts(spec_t, torch.as_tensor(pop), xt,
                                                     torch.as_tensor(y),
                                                     torch.as_tensor(om)), "masked counts")


def test_argmax_keeps_the_first_maximum():
    """All-equal logits (an all-zero genome) predict class 0, as jnp does;
    an all-masked row (every column INT32_MIN) also predicts 0."""
    spec_t = tg.GenomeSpec(tg.MLPTopology((4, 3, 3)))
    pop = torch.zeros((1, spec_t.n_genes), dtype=torch.int32)
    x = torch.as_tensor(np.random.default_rng(0).integers(0, 16, (20, 4)).astype(np.int32))
    assert (tmlp.mlp_forward(spec_t, pop, x)[0] == 0).all()
    y = torch.zeros(20, dtype=torch.int32)
    assert int(tmlp.population_correct_counts(spec_t, pop, x, y)[0]) == 20
    none = torch.zeros(3, dtype=torch.int32)
    assert int(tmlp.population_correct_counts(spec_t, pop, x, y, none)[0]) == 20


@pytest.mark.parametrize("sizes", TOPOS[:2])
@pytest.mark.parametrize("backend", ["ref", "jnp"])
def test_population_correct_matches_reference(sizes, backend):
    spec_j, spec_t, pop, x01, y = _case(sizes, P=20, S=300, seed=2)
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    ref = j_correct(jnp.asarray(pop), xj, jnp.asarray(y), spec=spec_j,
                    backend=backend, pop_tile=8, sample_tile=64)
    port = population_correct(torch.as_tensor(pop), xt, torch.as_tensor(y),
                              spec=spec_t, backend=backend, pop_tile=8,
                              sample_tile=64)
    assert_bits_equal(ref, port, backend)


def test_fitness_kernel_plain_version_matches_interpret_kernel():
    """The CUDA kernel's plain version (what its wrapper runs on a CPU
    tensor) against the reference Pallas kernel in interpret mode, with a
    partial row bound, a sample bound over −1-labelled padding and an
    output-column mask. Rows past the bound: the reference leaves them
    unspecified, the port returns 0."""
    sizes = (6, 4, 3)
    spec_j, spec_t, pop, x01, y = _case(sizes, P=16, S=200, seed=3)
    n_samp = 150
    y[n_samp:] = -1                                 # padded samples
    om = np.array([1, 1, 0], np.int32)
    xj = jq.quantize_inputs(jnp.asarray(x01), 4)
    xt = tq.quantize_inputs(torch.as_tensor(x01), 4)
    for rows in (16, 11, 0):
        ref = np.asarray(j_correct(jnp.asarray(pop), xj, jnp.asarray(y), spec=spec_j,
                                   backend="interpret", n_valid_rows=jnp.int32(rows),
                                   n_valid_samples=jnp.int32(n_samp),
                                   out_mask=jnp.asarray(om)))
        kw = dict(spec=spec_t, n_valid_rows=torch.tensor(rows, dtype=torch.int32),
                  n_valid_samples=torch.tensor(n_samp, dtype=torch.int32),
                  out_mask=torch.as_tensor(om))
        args = (torch.as_tensor(pop), xt, torch.as_tensor(y))
        port = pop_mlp_correct(*args, **kw)              # CPU tensor → plain
        assert torch.equal(port, pop_mlp_correct_plain(*args, **kw))
        assert_bits_equal(ref[:rows], port[:rows], f"rows {rows}")
        assert (port[rows:] == 0).all()


def test_kernel_backend_on_a_cpu_tensor_raises():
    spec_t = tg.GenomeSpec(tg.MLPTopology((4, 2, 2)))
    pop = tg.random_population(prng.PRNGKey(0), spec_t.table(), 4)
    x = torch.zeros((5, 4), dtype=torch.int32)
    y = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        population_correct(pop, x, y, spec=spec_t, backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        population_correct(pop, x, y, spec=spec_t, backend="interpret")
    # "auto" takes the plain tiled path off the card
    assert torch.equal(population_correct(pop, x, y, spec=spec_t),
                       population_correct(pop, x, y, spec=spec_t, backend="ref"))
