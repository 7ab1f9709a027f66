"""Parity helpers for the PyTorch port's tests, and the state interop.

Every port test compares bit for bit: integer arrays exactly, float32
arrays through their int32 view (the stated tolerance is 0). The helpers
here are imported by the other ``test_torch_*`` files. The interop tests
carry a reference ``GAState`` into the port and back.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import GAConfig, engine
from repro.core.dedup import EvalCache
from repro.core.genome import MLPTopology, GenomeSpec
import repro_torch.core.engine as tengine
from repro_torch.core.interop import (genome_table_from_numpy,
                                      state_from_numpy, state_to_numpy)
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels.pop_generation import ops as tgen_ops
from repro_torch.kernels.pop_mlp import ops as tmlp_ops
from repro_torch.kernels.pop_variation import ops as tvar_ops

STATE_FIELDS = ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen")
NO_COUNTS = tuple(f for f in STATE_FIELDS if f != "counts")
CACHE_FIELDS = ("cache.rows", "cache.vals", "cache.stamp")


def bits(a) -> np.ndarray:
    """numpy view for exact comparison: float32 as its int32 bit pattern."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits_equal(ref, port, msg=""):
    """Integers equal, float32 equal bit for bit (tolerance 0)."""
    r, p = bits(ref), bits(port)
    assert r.shape == p.shape, f"{msg}: shape {r.shape} != {p.shape}"
    np.testing.assert_array_equal(r, p.astype(r.dtype), err_msg=msg)


def jax_leaves(state) -> dict:
    """The reference GAState as the interop leaves dict."""
    out = {f: np.asarray(getattr(state, f)) for f in STATE_FIELDS}
    if state.cache is not None:
        out.update({"cache.rows": np.asarray(state.cache.rows),
                    "cache.vals": np.asarray(state.cache.vals),
                    "cache.stamp": np.asarray(state.cache.stamp),
                    "cache.probes": state.cache.probes})
    return out


def jax_state(leaves: dict):
    """A reference GAState from interop leaves."""
    cache = None
    if "cache.rows" in leaves:
        cache = EvalCache(jnp.asarray(leaves["cache.rows"]),
                          jnp.asarray(leaves["cache.vals"]),
                          jnp.asarray(leaves["cache.stamp"]),
                          int(leaves["cache.probes"]))
    return engine.GAState(*(jnp.asarray(leaves[f]) for f in STATE_FIELDS), cache)


def assert_states_equal(ref_state, port_state, msg="", fields=STATE_FIELDS,
                        cache=True):
    """Reference GAState vs port GAState, field by field, bit for bit."""
    a, b = jax_leaves(ref_state), state_to_numpy(port_state)
    names = fields + (CACHE_FIELDS if cache and "cache.rows" in a else ())
    if cache:
        assert ("cache.rows" in a) == ("cache.rows" in b), f"{msg}: cache presence"
    for name in names:
        assert_bits_equal(a[name], b[name], f"{msg}: GAState.{name}")


def _pick_kernel_anywhere(path, name, device):
    return "kernel" if name == "kernel" else tbackend.pick(path, name, device)


def kernel_paths_on_cpu(monkeypatch):
    """Let the dispatchers take the "kernel" path on CPU tensors for the
    rest of the test (the package refuses it there): the kernel paths' own
    code runs end to end, and each CUDA kernel's wrapper, given a CPU
    tensor, runs its plain version."""
    for ops in (tmlp_ops, tvar_ops, tgen_ops):
        monkeypatch.setattr(ops, "pick", _pick_kernel_anywhere)


# -- interop -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_state(bc_dataset):
    ds = bc_dataset
    cfg = GAConfig(pop_size=16, seed=3, fitness_backend="ref")
    problem = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train,
                                       ds.y_train, cfg)
    state, _ = engine.init_state(problem, jax.random.PRNGKey(3))
    return state


def test_state_round_trip_reference_to_port_and_back(ref_state):
    leaves = jax_leaves(ref_state)
    port = state_from_numpy(leaves, device="cpu")
    assert port.pop.dtype == torch.int32 and port.obj.dtype == torch.float32
    assert port.cache is not None and port.cache.probes == ref_state.cache.probes
    back = state_to_numpy(port)
    for name in STATE_FIELDS + CACHE_FIELDS:
        assert back[name].dtype == leaves[name].dtype, name
        assert_bits_equal(leaves[name], back[name], name)
    again = jax_state(back)
    for name in STATE_FIELDS:
        assert_bits_equal(getattr(ref_state, name), getattr(again, name), name)


def test_state_without_cache_round_trips(ref_state):
    leaves = {k: v for k, v in jax_leaves(ref_state).items()
              if not k.startswith("cache.")}
    port = state_from_numpy(leaves)
    assert port.cache is None
    assert set(state_to_numpy(port)) == set(STATE_FIELDS)


def test_genome_table_from_numpy_matches_spec_table():
    spec_j = GenomeSpec(MLPTopology((6, 4, 3)))
    t = spec_j.table()
    port = genome_table_from_numpy(t.low, t.high, t.is_mask, t.mask_bits,
                                   t.ids, t.valid)
    own = tengine.GenomeSpec(tengine.MLPTopology((6, 4, 3))).table("cpu")
    for f in ("low", "high", "is_mask", "mask_bits", "ids", "valid"):
        assert_bits_equal(getattr(t, f), getattr(port, f), f)
        assert torch.equal(getattr(port, f), getattr(own, f)), f
