"""Duplicate-chromosome evaluation caching for the GA fitness hot loop,
PyTorch port of ``repro.core.dedup``.

Rows are hashed (two 32-bit multiplicative hashes), lexsorted so identical
rows are contiguous, confirmed by exact row compare, and the rows that need
evaluation are packed to the front of a fixed-shape batch evaluated with
``n_valid`` set to their count — a () int32 tensor computed on the device,
which the CUDA fitness kernel reads there. Values gather back to every
duplicate. :class:`EvalCache` is the fixed-size open-addressing table that
carries correct counts across generations.

Scatters are deterministic on every device: JAX's ``.at[].max/.min`` and
``segment_max`` become ``scatter_reduce`` (``amax``/``amin``); the
``mode="drop"`` writes go to a buffer one slot longer whose last slot is
dropped; ``.at[].set`` of cache rows uses ``amax`` with
``include_self=False`` (targets there are unique except the dropped slot),
so no ``index_put_`` ever sees duplicate indices.

:func:`dedup_eval_lanes` runs several independent lanes (each with its own
cache) through ONE evaluation bounded by the widest lane's count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .genome import MASK32
from .nsga2 import lexsort

INT32_MIN = -2**31


def _mul32(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values: one
    factor is split into 16-bit halves, so no partial product overflows."""
    lo = (x * (c & 0xFFFF)) & MASK32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash_rows(rows: torch.Tensor, ids=None):
    """(N, G) int32 → two (N,) uint32 hashes (as int64). ``ids``: per-gene
    coefficient indices (default: positions)."""
    x = rows.to(torch.int64) & MASK32
    g = (torch.arange(x.shape[1], dtype=torch.int64, device=rows.device)
         if ids is None else ids.to(torch.int64) & MASK32)
    c1 = ((_mul32(g, torch.tensor(2654435761, device=rows.device)) + 0x9E3779B9)
          & MASK32) | 1
    c2 = ((_mul32(g, torch.tensor(40503, device=rows.device)) + 0x85EBCA6B)
          & MASK32) | 1
    return (_mul32(x, c1).sum(dim=1) & MASK32,
            _mul32(x, c2).sum(dim=1) & MASK32)


# -- cross-generation evaluation cache ---------------------------------------

@dataclasses.dataclass
class EvalCache:
    """Fixed-size open-addressing chromosome → correct-count table.

    ``rows`` (C, G) int32 keyed chromosomes, ``vals`` (C,) int32 counts
    (or (C, K): one per device instance, ``cache_init(val_shape=(K,))``),
    ``stamp`` (C,) int32 the generation that last proved the entry useful
    (−1: empty). A row's candidate slots are ``(h1 + i·(h2|1)) mod C`` for
    ``i < probes`` (C a power of two); lookups confirm by exact row compare.
    Inserts overwrite the lowest-stamped probe slot; among inserts racing
    for one slot the lowest batch index wins."""

    rows: torch.Tensor
    vals: torch.Tensor
    stamp: torch.Tensor
    probes: int = 4

    @property
    def capacity(self) -> int:
        return self.vals.shape[0]


def cache_init(capacity: int, n_genes: int, probes: int = 4,
               val_shape: tuple = (), device="cpu") -> EvalCache:
    """Empty cache; ``capacity`` is rounded up to a power of two."""
    cap = 1 << max(1, int(capacity) - 1).bit_length()
    return EvalCache(torch.zeros((cap, n_genes), dtype=torch.int32, device=device),
                     torch.zeros((cap,) + tuple(val_shape), dtype=torch.int32,
                                 device=device),
                     torch.full((cap,), -1, dtype=torch.int32, device=device),
                     probes)


def _probe_slots(cache: EvalCache, h1, h2):
    """(N,) hash pair → (N, probes) int64 candidate slot indices."""
    offs = torch.arange(cache.probes, dtype=torch.int64, device=h1.device)
    raw = h1[:, None] + _mul32(offs[None, :], (h2 | 1)[:, None])
    return (raw & (cache.capacity - 1))


def cache_lookup(cache: EvalCache, keyed_rows, h1, h2):
    """Probe for each keyed row → (hit, vals, slot), each (N,); ``vals`` and
    ``slot`` are meaningful only where ``hit`` (misses report probe 0)."""
    slots = _probe_slots(cache, h1, h2)
    live = cache.stamp[slots] >= 0
    match = live & torch.all(cache.rows[slots] == keyed_rows[:, None, :], dim=-1)
    hit = match.any(dim=1)
    first = torch.argmax(match.to(torch.int32), dim=1)      # first True, like jnp
    slot = torch.gather(slots, 1, first[:, None])[:, 0]
    return hit, cache.vals[slot], slot


def _drop_write(buf: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].set(src, mode="drop")`` for indices unique below
    ``len(buf)`` (index ``len(buf)`` drops): an ``amax`` scatter without
    the old value into a buffer one slot longer, last slot discarded."""
    ext = torch.cat([buf, buf[:1]], dim=0)
    index = idx.reshape(idx.shape + (1,) * (src.dim() - 1)).expand_as(src)
    return ext.scatter_reduce(0, index, src, "amax", include_self=False)[:-1]


def cache_update(cache: EvalCache, keyed_rows, vals, insert, restamp,
                 hit_slot, h1, h2, gen) -> EvalCache:
    """Re-stamp useful hits and insert newly evaluated rows (``gen`` is the
    stamp for both); racing inserts keep the lowest row index."""
    C = cache.capacity                          # index C == drop
    dev = cache.stamp.device
    gen = torch.as_tensor(gen, dtype=torch.int32, device=dev)
    rs = torch.where(restamp, hit_slot, C)
    stamp = torch.cat([cache.stamp, cache.stamp[:1]]).scatter_reduce(
        0, rs, gen.expand(rs.shape).contiguous(), "amax")[:-1]
    # insert target: the lowest-stamped probe slot after re-stamping
    slots = _probe_slots(cache, h1, h2)
    oldest = torch.argmin(stamp[slots], dim=1)
    tgt = torch.gather(slots, 1, oldest[:, None])[:, 0]
    n = keyed_rows.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    winner = torch.full((C,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, tgt, torch.where(insert, idx, n), "amin")
    w = torch.where(insert & (winner[tgt] == idx), tgt, C)
    return EvalCache(_drop_write(cache.rows, w, keyed_rows),
                     _drop_write(cache.vals, w, vals),
                     _drop_write(stamp, w, gen.expand(w.shape).contiguous()),
                     cache.probes)


def _segment_max(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments hold the dtype's minimum."""
    out = torch.full((n,), torch.iinfo(data.dtype).min, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, seg, data, "amax", include_self=False)


def _broadcast(cond: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (N,) row mask shaped to select rows of an (N, ...) value tensor."""
    return cond.reshape(cond.shape + (1,) * (leaf.dim() - 1))


@dataclasses.dataclass
class _Pack:
    """One dedup problem between its packing and its unpacking: the rows to
    evaluate (``batch``, those needing evaluation first) and what maps the
    values back."""
    batch: torch.Tensor
    n_eval: torch.Tensor
    order: torch.Tensor
    uid: torch.Tensor
    needs: torch.Tensor
    grp_known: torch.Tensor | None = None
    grp_kidx: torch.Tensor | None = None
    known: torch.Tensor | None = None
    sp: torch.Tensor | None = None
    hs: tuple | None = None
    hit: torch.Tensor | None = None
    cval: torch.Tensor | None = None
    cslot: torch.Tensor | None = None
    useful: torch.Tensor | None = None
    n_hit: torch.Tensor | None = None


def _pack(rows, known, gene_mask, cache, ids) -> _Pack:
    N = rows.shape[0]
    keyed = rows if gene_mask is None else torch.where(gene_mask, rows, 0)
    h1, h2 = hash_rows(keyed, ids)
    order = lexsort((h2, h1))
    sp = keyed[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=rows.device),
                       (sp[1:] != sp[:-1]).any(dim=1)])
    uid = torch.cumsum(first.long(), 0) - 1                 # group id per sorted row
    pk = _Pack(rows, None, order, uid, first, known=known)
    if known is not None:
        is_known = order < known.shape[0]
        pk.grp_known = _segment_max(is_known.to(torch.int32), uid, N)
        pk.grp_kidx = _segment_max(torch.where(is_known, order, -1), uid, N)
        pk.needs = first & (pk.grp_known[uid] == 0)
    if cache is not None:
        pk.sp, pk.hs = sp, (h1[order], h2[order])
        pk.hit, pk.cval, pk.cslot = cache_lookup(cache, sp, *pk.hs)
        pk.useful = pk.needs & pk.hit               # leaders saved from evaluation
        pk.needs = pk.needs & ~pk.hit
        pk.n_hit = pk.useful.sum(dtype=torch.int32)
    pack = torch.sort((~pk.needs).to(torch.int32), stable=True).indices
    pk.n_eval = pk.needs.sum(dtype=torch.int32)
    pk.batch = rows[order][pack]                    # actual, unmasked rows
    return pk


def _unpack(pk: _Pack, evaluated, cache, gen):
    N = pk.order.shape[0]
    uid, needs = pk.uid, pk.needs
    slot = torch.cumsum(needs.long(), 0) - 1
    grp_slot = _segment_max(torch.where(needs, slot, -1), uid, N)
    val = evaluated[torch.clamp_min(grp_slot[uid], 0)]
    if cache is not None:
        val = torch.where(_broadcast(pk.hit, val), pk.cval, val)
    if pk.known is not None:
        reuse = pk.grp_known[uid] == 1
        val = torch.where(_broadcast(reuse, val),
                          pk.known[torch.clamp_min(pk.grp_kidx[uid], 0)], val)
    out = torch.empty_like(val)
    out[pk.order] = val                    # order is a permutation
    if cache is None:
        return out, pk.n_eval
    ins_val = evaluated[torch.clamp_min(slot, 0)]
    gen = 0 if gen is None else gen
    new_cache = cache_update(cache, pk.sp, ins_val, needs, pk.useful, pk.cslot,
                             *pk.hs, gen)
    return out, pk.n_eval, pk.n_hit, new_cache


def dedup_eval(eval_fn, rows: torch.Tensor, known=None, gene_mask=None,
               cache: EvalCache | None = None, gen=None, ids=None):
    """Evaluate ``rows`` with duplicate suppression → per-row values.

    eval_fn(batch, n_valid) → (len(batch), ...) tensor (one value per row,
        e.g. an (N, K) count per device instance); only the first
        ``n_valid`` rows (a () int32 device tensor) need values.
    known: optional (M, ...) values already computed for ``rows[:M]``; any
        row identical to one of them reuses its value.
    gene_mask: optional (G,) validity mask; hashing and comparison see
        only valid genes, ``eval_fn`` the actual rows.
    cache: optional :class:`EvalCache` (cross-generation path); ``gen`` is
        the stamp of its inserts and re-stamps.
    ids: per-gene hash-coefficient indices (:func:`hash_rows`).

    Returns ``(values, n_eval)`` or, with a cache, ``(values, n_eval,
    n_hit, new_cache)``; n_eval/n_hit are () int32 device tensors.
    """
    pk = _pack(rows, known, gene_mask, cache, ids)
    return _unpack(pk, eval_fn(pk.batch, pk.n_eval), cache, gen)


def dedup_eval_lanes(eval_fn, rows, known=None, gene_mask=None, cache=None,
                     gen=None, ids=None):
    """:func:`dedup_eval` over L independent lanes with ONE evaluation:
    every argument but ``eval_fn`` is a list with one entry per lane (or
    None for all lanes). Each lane packs the rows it needs first; the
    packed batches stack to (L, N, G) and ``eval_fn(batch, n_valid)``
    evaluates them with ``n_valid`` the max of the lanes' counts (a ()
    int32 device tensor: the reference's ``lax.pmax`` over the batch
    axis), returning (L, N, ...). Rows between a lane's own count and
    that bound are evaluated but never gathered, so each lane's values,
    ``n_eval``, ``n_hit`` and cache equal its own :func:`dedup_eval`'s.
    Returns the per-lane results as a list."""
    L = len(rows)
    each = lambda a: [None] * L if a is None else a
    known, gene_mask, cache, gen, ids = map(each, (known, gene_mask, cache, gen, ids))
    packs = [_pack(rows[i], known[i], gene_mask[i], cache[i], ids[i]) for i in range(L)]
    bound = torch.stack([pk.n_eval for pk in packs]).amax()
    evaluated = eval_fn(torch.stack([pk.batch for pk in packs]), bound)
    return [_unpack(pk, evaluated[i], cache[i], gen[i]) for i, pk in enumerate(packs)]


def unique_rows(rows: np.ndarray):
    """Host-side twin: (uniq, inverse) with rows == uniq[inverse]."""
    uniq, inverse = np.unique(np.asarray(rows), axis=0, return_inverse=True)
    return uniq, inverse.reshape(-1)
