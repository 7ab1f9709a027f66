"""A named grid of mesh entries on one device: the port's stand-in for a
JAX mesh (``repro.launch.mesh``, ``jax.make_mesh``).

Each entry of a :class:`DeviceMesh` is one island (``core.islands``) or one
slice of sweep cells (``core.sweep``), and every entry lives on the mesh's
one ``torch.device``: the entries run as lanes of one batched problem, so a
mesh of 16 entries on one card launches each kernel once for all of them.
Entries on distinct devices are not ported yet (ROADMAP A13b): any mesh
that is not a :class:`DeviceMesh` (a JAX mesh spans devices) raises
``NotImplementedError``.

Importing this module touches no device, and nothing of ``core``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import device_of, not_ported


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """``axis_sizes[i]`` entries along ``axis_names[i]``, all on ``device``.
    ``shape`` maps each axis name to its size, as a JAX mesh's does."""

    axis_sizes: tuple
    axis_names: tuple
    device: torch.device

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.axis_sizes)
        names = tuple(str(a) for a in self.axis_names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh needs one distinct name per axis: sizes {sizes}, "
                             f"names {names}")
        if any(s < 1 for s in sizes):
            raise ValueError(f"mesh axes must hold at least one entry: {sizes}")
        object.__setattr__(self, "axis_sizes", sizes)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "device", device_of(self.device))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def entries(self, axis_names) -> int:
        """The entries along ``axis_names``: the islands of a ring, or the
        slices a sweep's cells pad to (axes not named replicate)."""
        missing = [a for a in axis_names if a not in self.shape]
        if missing:
            raise ValueError(f"axis names {missing} are not in the mesh {self.shape}")
        return math.prod(self.shape[a] for a in axis_names)


def make_mesh(axis_shapes, axis_names, device=None) -> DeviceMesh:
    """A :class:`DeviceMesh` on ``device`` (the card by default; without
    one this raises unless ``device="cpu"`` is given)."""
    return DeviceMesh(tuple(axis_shapes), tuple(axis_names),
                      "cuda" if device is None else device)


def make_host_mesh() -> DeviceMesh:
    """The degenerate (1, 1) ("data", "model") mesh on the CPU."""
    return make_mesh((1, 1), ("data", "model"), device="cpu")


def as_device_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a :class:`DeviceMesh`; any other mesh (a JAX mesh
    spans devices) raises for ROADMAP A13b."""
    if not isinstance(mesh, DeviceMesh):
        raise not_ported(f"mesh entries on distinct devices ({type(mesh).__name__} "
                         "as mesh=)", "A13b")
    return mesh
