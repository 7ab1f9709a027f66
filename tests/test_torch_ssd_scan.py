"""The port's SSD inter-chunk state scan against the reference on the CPU:
``state_scan`` and the wrapper ``ssd_state_scan`` (whose CPU tensors run
the kernel's plain version) against the jnp oracle and the Pallas kernel
in interpret mode, at ``tests/test_kernels.py``'s shapes.

Tolerance rtol = atol = 1e-6, the JAX test's own bound: the port rounds
the multiply and the add of ``h * decay + state`` apart (as its CUDA
kernel does), while XLA:CPU may fuse them. Chunk 0 is exactly 0."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

import repro.core  # noqa: F401  (the reference's kernels import through its core)
from repro.kernels.ssd_scan import ssd_state_scan as j_kernel, ssd_state_scan_ref as j_ref
from repro_torch.kernels.ssd_scan import (ssd_state_scan, ssd_state_scan_plain,
                                          ssd_state_scan_ref, state_scan)

SHAPES = [(1, 4, 8, 8, 16, 8), (2, 7, 16, 16, 32, 8), (3, 2, 32, 8, 8, 16)]


def _inputs(b, nc, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    sc = rng.standard_normal((b, nc, H, P, N)).astype(np.float32)
    dec = rng.random((b, nc, H)).astype(np.float32)
    return sc, dec


@pytest.mark.parametrize("b,nc,H,P,N,bh", SHAPES)
def test_state_scan_matches_reference(b, nc, H, P, N, bh):
    sc, dec = _inputs(b, nc, H, P, N, seed=nc)
    want_ref = np.asarray(j_ref(jnp.asarray(sc), jnp.asarray(dec)))
    want_kernel = np.asarray(j_kernel(jnp.asarray(sc), jnp.asarray(dec), bh=bh,
                                      interpret=True))
    ts, td = torch.as_tensor(sc), torch.as_tensor(dec)
    for got in (state_scan(ts, td), ssd_state_scan(ts, td), ssd_state_scan_ref(ts, td)):
        assert got.dtype == torch.float32 and tuple(got.shape) == sc.shape
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        assert (got[:, 0] == 0).all()


def test_unit_decay_gives_prefix_sums():
    sc, _ = _inputs(1, 3, 8, 8, 8)
    out = state_scan(torch.as_tensor(sc), torch.ones((1, 3, 8)))
    assert float(out[:, 0].abs().max()) == 0.0
    np.testing.assert_array_equal(out[:, 1].numpy(), sc[:, 0])
    np.testing.assert_array_equal(out[:, 2].numpy(), sc[:, 0] + sc[:, 1])


def test_plain_version_rounds_multiply_and_add_apart():
    """The plain version is the CUDA kernel's arithmetic: ``fl(fl(h·d) + s)``
    step by step, here checked in float64 emulation."""
    sc, dec = _inputs(2, 5, 4, 4, 8, seed=3)
    got = ssd_state_scan_plain(torch.as_tensor(sc), torch.as_tensor(dec)).numpy()
    h = np.zeros((2, 4, 4, 8), np.float32)
    for c in range(5):
        np.testing.assert_array_equal(got[:, c], h)
        prod = (h.astype(np.float64) * dec[:, c, :, None, None]).astype(np.float32)
        h = (prod.astype(np.float64) + sc[:, c]).astype(np.float32)


@pytest.mark.parametrize("H,bh", [(12, 8), (6, 4)])
def test_heads_per_block_is_checked_as_the_reference_checks_it(H, bh):
    """The reference refuses heads-per-block that do not divide H; the port
    takes no ``bh`` (one thread per state element), so the same shapes run
    and equal the plain version and the reference's oracle."""
    sc, dec = _inputs(1, 2, H, 4, 4)
    with pytest.raises(AssertionError):
        j_kernel(jnp.asarray(sc), jnp.asarray(dec), bh=bh, interpret=True)
    with pytest.raises(TypeError):
        ssd_state_scan(torch.as_tensor(sc), torch.as_tensor(dec), bh=bh)
    got = ssd_state_scan(torch.as_tensor(sc), torch.as_tensor(dec))
    assert torch.equal(got, ssd_state_scan_plain(torch.as_tensor(sc), torch.as_tensor(dec)))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ref(jnp.asarray(sc),
                                                             jnp.asarray(dec))),
                               rtol=1e-6, atol=1e-6)
