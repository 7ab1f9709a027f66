"""Carry GA state between the JAX reference and the port as numpy arrays —
the port's counterpart of carrying weights across.

The leaves are those of ``repro.core.engine.GAState`` with the reference's
dtypes: ``pop`` int32 (P, G), ``obj`` float32 (P, 2), ``viol`` float32
(P,), ``rank`` int32 (P,), ``crowd`` float32 (P,), ``counts`` int32 (P,),
``key`` uint32 (2,), ``gen`` int32 (), and, when the state carries an
EvalCache, ``cache.rows`` int32 (C, G), ``cache.vals`` int32 (C,),
``cache.stamp`` int32 (C,) and ``cache.probes`` (an int).
"""
from __future__ import annotations

import numpy as np
import torch

from .dedup import EvalCache
from .engine import GAState
from .genome import GeneTable

_INT32 = ("pop", "rank", "counts", "gen")
_FLOAT32 = ("obj", "viol", "crowd")
_CACHE = ("rows", "vals", "stamp")


def genome_table_from_numpy(low, high, is_mask, mask_bits, ids, valid,
                            device="cpu") -> GeneTable:
    """A GeneTable from the reference table's six (G,) arrays."""
    t = lambda a, dt: torch.tensor(np.asarray(a, dt), device=device)
    return GeneTable(t(low, np.int32), t(high, np.int32), t(is_mask, bool),
                     t(mask_bits, np.int32), t(ids, np.int32), t(valid, bool))


def state_from_numpy(leaves: dict, device="cpu") -> GAState:
    """GAState on ``device`` from the reference leaves (see module doc)."""
    t = lambda name, dt: torch.tensor(np.asarray(leaves[name], dt), device=device)
    cache = None
    if "cache.rows" in leaves:
        cache = EvalCache(*(t(f"cache.{n}", np.int32) for n in _CACHE),
                          int(leaves["cache.probes"]))
    key = torch.tensor(np.asarray(leaves["key"], np.uint32).astype(np.int64),
                       device=device)
    return GAState(t("pop", np.int32), t("obj", np.float32), t("viol", np.float32),
                   t("rank", np.int32), t("crowd", np.float32),
                   t("counts", np.int32), key, t("gen", np.int32).reshape(()),
                   cache)


def state_to_numpy(state: GAState) -> dict:
    """The reference leaves of a port GAState, as numpy arrays."""
    out = {n: getattr(state, n).cpu().numpy().astype(np.int32) for n in _INT32}
    out.update({n: getattr(state, n).cpu().numpy().astype(np.float32)
                for n in _FLOAT32})
    out["key"] = state.key.cpu().numpy().astype(np.uint32)
    if state.cache is not None:
        for n in _CACHE:
            out[f"cache.{n}"] = getattr(state.cache, n).cpu().numpy().astype(np.int32)
        out["cache.probes"] = state.cache.probes
    return out
