"""The port's duplicate suppression and EvalCache against the reference:
hashes (with the hand-built colliding rows of tests/test_dedup_cache.py),
dedup_eval with and without known values, and the cache tables themselves
(rows, vals, stamps) call after call, eviction included; tolerance 0."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import dedup as jd
from repro_torch.core import dedup as td
from test_dedup_cache import _colliding_rows
from test_torch_interop import assert_bits_equal


def _j_eval(batch, n_valid):
    del n_valid
    return jnp.sum(batch, axis=1)


def _t_eval(batch, n_valid):
    """Synthetic fitness; rows past n_valid are not evaluated (0)."""
    out = batch.sum(dim=1, dtype=torch.int32)
    return torch.where(torch.arange(len(batch)) < n_valid, out, 0)


def _assert_cache_equal(cj, ct, msg):
    for f in ("rows", "vals", "stamp"):
        assert_bits_equal(getattr(cj, f), getattr(ct, f), f"{msg}: cache.{f}")


def test_hash_rows_matches_reference_with_wraparound():
    rng = np.random.default_rng(0)
    rows = rng.integers(-2**31, 2**31, (40, 33), dtype=np.int64).astype(np.int32)
    ids = rng.permutation(33).astype(np.int32)
    for i in (None, ids):
        hj = jd.hash_rows(jnp.asarray(rows), None if i is None else jnp.asarray(i))
        ht = td.hash_rows(torch.as_tensor(rows), None if i is None else torch.as_tensor(i))
        for a, b in zip(hj, ht):
            assert_bits_equal(np.asarray(a).astype(np.int64), b, "hash")


def test_colliding_rows_collide_in_the_port_and_stay_exact():
    row_a, row_b = _colliding_rows()
    rows = np.stack([row_a, row_b])
    h1, h2 = td.hash_rows(torch.as_tensor(rows))
    assert int(h1[0]) == int(h1[1]) and int(h2[0]) == int(h2[1])
    cj = jd.cache_init(8, rows.shape[1])
    ct = td.cache_init(8, rows.shape[1])
    for gen, want in enumerate([(2, 0), (1, 1), (0, 2)]):
        oj, ej, hj, cj = jd.dedup_eval(_j_eval, jnp.asarray(rows), cache=cj,
                                       gen=jnp.int32(gen))
        ot, et, ht, ct = td.dedup_eval(_t_eval, torch.as_tensor(rows), cache=ct,
                                       gen=gen)
        assert_bits_equal(oj, ot, f"call {gen}")
        assert (int(et), int(ht)) == (int(ej), int(hj)) == want
        _assert_cache_equal(cj, ct, f"call {gen}")


@pytest.mark.parametrize("capacity", [4, 64])
def test_dedup_eval_with_cache_matches_reference_call_after_call(capacity):
    """Repeated rows, known parent values and a cache small enough to
    evict: outputs, accounting and the whole table equal the reference."""
    rng = np.random.default_rng(capacity)
    uniq = np.unique(rng.integers(0, 50, (40, 5)), axis=0)[:16].astype(np.int32)
    cj = jd.cache_init(capacity, 5)
    ct = td.cache_init(capacity, 5)
    known_j = known_t = None
    for call in range(6):
        rows = uniq[rng.integers(0, 16, 12)]
        kw_j = {} if known_j is None else {"known": known_j}
        kw_t = {} if known_t is None else {"known": known_t}
        oj, ej, hj, cj = jd.dedup_eval(_j_eval, jnp.asarray(rows), cache=cj,
                                       gen=jnp.int32(call), **kw_j)
        ot, et, ht, ct = td.dedup_eval(_t_eval, torch.as_tensor(rows), cache=ct,
                                       gen=call, **kw_t)
        assert_bits_equal(oj, ot, f"call {call}")
        assert (int(ej), int(hj)) == (int(et), int(ht)), f"call {call}"
        _assert_cache_equal(cj, ct, f"call {call}")
        known_j, known_t = oj[:6], ot[:6]


def test_dedup_eval_without_cache_and_gene_mask():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3, (20, 6)).astype(np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1], bool)
    known = np.arange(5, dtype=np.int32) * 7
    for kw in ({}, {"known": known}):
        oj, ej = jd.dedup_eval(_j_eval, jnp.asarray(rows), gene_mask=jnp.asarray(mask),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        ot, et = td.dedup_eval(_t_eval, torch.as_tensor(rows),
                               gene_mask=torch.as_tensor(mask),
                               **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert_bits_equal(oj, ot, f"{sorted(kw)}")
        assert int(ej) == int(et)


def test_cache_init_and_unique_rows():
    for cap, want in ((4, 4), (5, 8), (4096, 4096)):
        c = td.cache_init(cap, 3)
        assert c.capacity == want == jd.cache_init(cap, 3).capacity
        assert (c.stamp == -1).all() and c.rows.shape == (want, 3)
    rows = np.array([[1, 2], [0, 1], [1, 2]])
    uniq, inv = td.unique_rows(rows)
    np.testing.assert_array_equal(uniq[inv], rows)
