"""The port's variation against the reference at equal keys: the fused
"ref" path, the chained-operator "ops" oracle and the plain version of the
CUDA variation kernel, each against the reference's ref / interpret-mode
Pallas kernel / ops, including populations whose half is odd (the swap
draws of a row pair then straddle two counters); tolerance 0."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import genome as jg, operators as jops
from repro.kernels.pop_variation import population_variation as j_var
from repro.kernels.pop_variation.kernel import pop_variation_kernel as j_kernel
from repro_torch.core import genome as tg, operators as tops, prng
from repro_torch.kernels.pop_variation import (population_variation,
                                               pop_variation_kernel,
                                               pop_variation_plain)
from test_torch_interop import assert_bits_equal, kernel_paths_on_cpu

SIZES = (10, 3, 2)


def _pop(P, seed):
    spec_t = tg.GenomeSpec(tg.MLPTopology(SIZES))
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec_t.low, spec_t.high, (P, spec_t.n_genes)).astype(np.int32)
    rank = rng.integers(0, 3, P).astype(np.int32)
    crowd = rng.random(P).astype(np.float32)
    return pop, rank, crowd


@pytest.mark.parametrize("P", [6, 16])
@pytest.mark.parametrize("port_backend,ref_backend",
                         [("ref", "ref"), ("ops", "ops"), ("kernel", "interpret")])
def test_population_variation_matches_reference(port_backend, ref_backend, P,
                                                monkeypatch):
    kernel_paths_on_cpu(monkeypatch)
    spec_j = jg.GenomeSpec(jg.MLPTopology(SIZES))
    spec_t = tg.GenomeSpec(tg.MLPTopology(SIZES))
    pop, rank, crowd = _pop(P, seed=P)
    for seed, pm in ((0, 0.02), (5, 0.6)):
        ref = j_var(jax.random.PRNGKey(seed), jnp.asarray(pop), jnp.asarray(rank),
                    jnp.asarray(crowd), genes=spec_j.table(), pc=jnp.float32(0.7),
                    pm=jnp.float32(pm), backend=ref_backend, pop_tile=4)
        port = population_variation(
            prng.PRNGKey(seed), torch.as_tensor(pop), torch.as_tensor(rank),
            torch.as_tensor(crowd), genes=spec_t.table(),
            pc=torch.tensor(0.7), pm=torch.tensor(pm, dtype=torch.float32),
            backend=port_backend)
        assert_bits_equal(ref, port, f"{port_backend} seed {seed} pm {pm}")


@pytest.mark.parametrize("P", [2, 6, 10])
def test_variation_kernel_plain_version_matches_interpret_kernel(P):
    """The kernel's plain version against the Pallas kernel directly, on
    child frames with every crossover gate pattern and a high mutation
    rate (every gene family mutates)."""
    spec_j = jg.GenomeSpec(jg.MLPTopology(SIZES))
    t = spec_j.table()
    rng = np.random.default_rng(P)
    a, b = (rng.integers(np.asarray(t.low), np.asarray(t.high),
                         (P, spec_j.n_genes)).astype(np.int32) for _ in range(2))
    do = rng.random(P) < 0.5
    keys = np.asarray(jg._slot_keys(jax.random.PRNGKey(P), (0, 1, 2)))
    for pm in (0.05, 0.9):
        ref = j_kernel(jnp.asarray(a), jnp.asarray(b), jnp.asarray(do), t.low, t.high,
                       t.is_mask, t.mask_bits, t.ids, jnp.asarray(keys),
                       jnp.float32(pm), bp=4, interpret=True)
        tt = tg.GenomeSpec(tg.MLPTopology(SIZES)).table()
        args = (torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(do), tt.low,
                tt.high, tt.is_mask, tt.mask_bits, tt.ids,
                torch.as_tensor(keys.astype(np.int64)),
                torch.tensor(pm, dtype=torch.float32))
        port = pop_variation_kernel(*args)            # CPU tensor → plain
        assert torch.equal(port, pop_variation_plain(*args))
        assert_bits_equal(ref, port, f"P {P} pm {pm}")


def test_mutate_and_crossover_operators_match_reference():
    spec_j = jg.GenomeSpec(jg.MLPTopology(SIZES))
    spec_t = tg.GenomeSpec(tg.MLPTopology(SIZES))
    pop, _, _ = _pop(8, seed=1)
    kj, kt = jax.random.PRNGKey(4), prng.PRNGKey(4)
    for pm in (0.1, 1.0):
        assert_bits_equal(jops.mutate(kj, jnp.asarray(pop), spec_j, pm),
                          tops.mutate(kt, torch.as_tensor(pop), spec_t,
                                      torch.tensor(pm, dtype=torch.float32)),
                          f"mutate {pm}")
    cj = jops.uniform_crossover(kj, jax.random.PRNGKey(5), jnp.asarray(pop[:4]),
                                jnp.asarray(pop[4:]), 0.7, spec_j.gene_ids)
    ct = tops.uniform_crossover(kt, prng.PRNGKey(5), torch.as_tensor(pop[:4]),
                                torch.as_tensor(pop[4:]), torch.tensor(0.7),
                                torch.as_tensor(spec_t.gene_ids))
    for a, b in zip(cj, ct):
        assert_bits_equal(a, b, "crossover")


def test_variation_rejects_odd_populations_and_kernel_on_cpu():
    spec_t = tg.GenomeSpec(tg.MLPTopology(SIZES))
    pop, rank, crowd = (torch.as_tensor(a) for a in _pop(6, seed=2))
    kw = dict(genes=spec_t, pc=torch.tensor(0.7), pm=torch.tensor(0.02))
    with pytest.raises(ValueError, match="even"):
        population_variation(prng.PRNGKey(0), pop[:5], rank[:5], crowd[:5], **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        population_variation(prng.PRNGKey(0), pop, rank, crowd, backend="kernel", **kw)
