"""The port's FA-count area model against the reference, bit for bit, on
random in-bounds populations of every paper topology, the all-zero and
all-max genomes and exact-seed (doping) genomes."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import area as jarea, genome as jg
from repro.data.tabular import TOPOLOGIES
from repro_torch.core import area as tarea, genome as tg
from test_torch_interop import assert_bits_equal


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_population_area_matches_reference(name):
    sizes = TOPOLOGIES[name]
    spec_j = jg.GenomeSpec(jg.MLPTopology(sizes))
    spec_t = tg.GenomeSpec(tg.MLPTopology(sizes))
    rng = np.random.default_rng(len(name))
    pop = rng.integers(spec_t.low, spec_t.high, (24, spec_t.n_genes)).astype(np.int32)
    pop[0] = 0
    pop[1] = spec_t.high - 1
    pop[2] = spec_t.low
    w = [rng.normal(size=(sizes[l], sizes[l + 1])) for l in range(len(sizes) - 1)]
    b = [rng.normal(size=sizes[l + 1]) for l in range(len(sizes) - 1)]
    pop[3] = spec_t.exact_seed(w, b)
    np.testing.assert_array_equal(spec_j.exact_seed(w, b), pop[3])
    ref = jax.jit(jarea.population_area, static_argnums=0)(spec_j, jnp.asarray(pop))
    port = tarea.population_area(spec_t, torch.as_tensor(pop))
    assert port.dtype == torch.int32
    assert_bits_equal(ref, port, name)
    assert int(tarea.mlp_fa_count(spec_t, torch.as_tensor(pop[5]))) == int(ref[5])
