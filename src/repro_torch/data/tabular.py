"""Synthetic UCI-analog tabular datasets (paper §V-A).

A copy of ``repro.data.tabular`` (numpy only), so the port generates the
same data without importing the JAX package.

The five UCI datasets are replaced by seeded,
class-structured Gaussian-mixture generators with the *exact* signature
(features, classes, samples, class balance difficulty) of the paper's
datasets. The paper's MLP topologies attach unchanged. EXPERIMENTS.md
validates relative claims on this data (DESIGN.md §3, "Assumption changes").

Separability is tuned per dataset so the float-MLP baseline lands near the
paper's Table I accuracy (e.g. wine-quality datasets are intentionally hard:
the paper's baselines reach only 0.56 / 0.54).
"""
from __future__ import annotations

import dataclasses

import numpy as np

# name → (n_features, n_classes, n_samples, class_sep, ordinal)
# class_sep calibrated so baseline accuracy ≈ paper Table I.
_SPECS: dict[str, tuple[int, int, int, float, bool]] = {
    "breast_cancer": (10, 2, 699, 1.05, False),    # Acc ≈ 0.98
    "cardio":        (21, 3, 2126, 0.55, False),  # Acc ≈ 0.88
    "pendigits":     (16, 10, 10992, 1.6, False), # Acc ≈ 0.94
    "redwine":       (11, 6, 1599, 1.3, True),    # Acc ≈ 0.56
    "whitewine":     (11, 7, 4898, 1.2, True),    # Acc ≈ 0.54
}

# paper Table I topologies (input, hidden, classes)
TOPOLOGIES: dict[str, tuple[int, ...]] = {
    "breast_cancer": (10, 3, 2),
    "cardio": (21, 3, 3),
    "pendigits": (16, 5, 10),
    "redwine": (11, 2, 6),
    "whitewine": (11, 4, 7),
}

DATASETS = tuple(_SPECS)


@dataclasses.dataclass
class TabularDataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_features: int
    n_classes: int

    @property
    def topology(self) -> tuple[int, ...]:
        return TOPOLOGIES[self.name]


def _make_classification(n: int, d: int, c: int, sep: float, rng: np.random.Generator,
                         ordinal: bool = False):
    """Gaussian mixture with ``c`` clusters, inputs → [0, 1].

    ``ordinal=True`` (wine-quality style): classes sit along a 1-D manifold
    with neighbour overlap — matches the paper's low wine accuracies.
    """
    if ordinal:
        u = rng.normal(0.0, 1.0, (1, d))
        u /= np.linalg.norm(u)
        centers = (np.arange(c)[:, None] - c / 2) * sep * u
        centers += rng.normal(0.0, 0.15 * sep, (c, d))
    else:
        centers = rng.normal(0.0, 1.0, (c, d))
        centers *= sep / np.maximum(
            np.linalg.norm(centers, axis=1, keepdims=True) / np.sqrt(d), 1e-9)
    y = rng.integers(0, c, n)
    scales = 0.6 + 0.8 * rng.random((c, d))
    x = centers[y] + rng.normal(0.0, 1.0, (n, d)) * scales[y]
    # min-max normalize to [0, 1] as in the paper (§V-A)
    x = (x - x.min(0)) / np.maximum(x.max(0) - x.min(0), 1e-9)
    return x.astype(np.float32), y.astype(np.int32)


def load_dataset(name: str, seed: int = 0, train_frac: float = 0.7) -> TabularDataset:
    """70/30 stratified split, matching the paper's protocol (§V-A)."""
    import zlib

    d, c, n, sep, ordinal = _SPECS[name]
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()))  # stable hash
    x, y = _make_classification(n, d, c, sep, rng, ordinal)

    # stratified split
    tr_idx, te_idx = [], []
    for cls in range(c):
        idx = np.where(y == cls)[0]
        rng.shuffle(idx)
        k = int(round(train_frac * len(idx)))
        tr_idx.append(idx[:k])
        te_idx.append(idx[k:])
    tr = np.concatenate(tr_idx)
    te = np.concatenate(te_idx)
    rng.shuffle(tr)
    rng.shuffle(te)
    return TabularDataset(name, x[tr], y[tr], x[te], y[te], d, c)
