"""Pareto-front utilities: extraction, hypervolume, accuracy-loss filtering.

A copy of ``repro.core.pareto`` (numpy only).
"""
from __future__ import annotations

import numpy as np


def nondominated_mask(obj: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of a (P, M) minimize-objective set."""
    obj = np.asarray(obj)
    P = obj.shape[0]
    le = np.all(obj[:, None, :] <= obj[None, :, :], axis=-1)
    lt = np.any(obj[:, None, :] < obj[None, :, :], axis=-1)
    dom = le & lt & ~np.eye(P, dtype=bool)
    return ~dom.any(axis=0)


def pareto_front(obj: np.ndarray, extras: dict | None = None):
    """Return sorted non-dominated subset (and matching rows of extras)."""
    mask = nondominated_mask(obj)
    idx = np.where(mask)[0]
    order = idx[np.argsort(obj[idx, 0])]
    out = {"objectives": obj[order], "indices": order}
    if extras:
        out.update({k: np.asarray(v)[order] for k, v in extras.items()})
    return out


def hypervolume_2d(obj: np.ndarray, ref: tuple[float, float]) -> float:
    """Exact 2-D hypervolume (both objectives minimized) w.r.t. ``ref``."""
    front = pareto_front(np.asarray(obj, np.float64))["objectives"]
    front = front[(front[:, 0] < ref[0]) & (front[:, 1] < ref[1])]
    if front.size == 0:
        return 0.0
    hv, prev_f2 = 0.0, ref[1]
    for f1, f2 in front:  # sorted by f1 ascending → f2 descending on a front
        hv += (ref[0] - f1) * (prev_f2 - f2)
        prev_f2 = f2
    return float(hv)


def best_within_loss(obj: np.ndarray, baseline_err: float, max_loss: float):
    """Paper Table II selection: smallest area with error ≤ baseline+max_loss."""
    obj = np.asarray(obj)
    ok = obj[:, 0] <= baseline_err + max_loss
    if not ok.any():
        return None
    idx = np.where(ok)[0]
    return int(idx[np.argmin(obj[idx, 1])])
