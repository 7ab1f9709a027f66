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


def _reduce_to_completion(cols):
    """3:2 reduction simulated until every column is at most 2 high (no
    round limit), then the carry-propagate adder."""
    cols, total = list(cols), 0
    while max(cols) > 2:
        new = [0] * len(cols)
        for c, n in enumerate(cols):
            total += n // 3
            new[c] += n - 2 * (n // 3)
            if c + 1 < len(cols):
                new[c + 1] += n // 3
        cols = new
    return total + sum(n >= 2 for n in cols)


def test_reduce_keeps_the_reference_round_limit():
    """ROADMAP C7: a carry rippling along columns of height 2 needs 17
    rounds on this histogram; the reference stops at 16 and counts 256 FAs
    where the reduction run to completion counts 257. The port keeps the
    reference's 16 rounds, so it counts 256 too."""
    hist = [30, 6, 13, 10, 0, 15, 30, 26, 13, 4, 19, 9, 26, 27, 25, 10, 6, 3, 6]
    cols = hist + [0] * (tarea._N_COLS - len(hist))
    ref, _ = jax.jit(jarea._reduce_columns)(jnp.asarray(cols, jnp.int32))
    port, _ = tarea._reduce_columns(torch.as_tensor(cols, dtype=torch.int32))
    assert int(ref) == int(port) == 256
    assert _reduce_to_completion(cols) == 257
