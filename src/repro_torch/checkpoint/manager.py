"""Atomic, crc-verified checkpoint store, PyTorch port of
``repro.checkpoint.manager`` in the same on-disk format.

Layout per step:
    <dir>/step_00000120/
        manifest.json        step, and per leaf shape, dtype, crc32
        <leafpath>.npy       one array per leaf of the saved tree

Guarantees:
  * atomic commit: written into ``step_XXXXXXXX.tmp`` then ``os.rename``
    (readers never observe a partial checkpoint);
  * integrity: crc32 per leaf over BOTH the array payload and the raw
    ``.npy`` file bytes (``file_crc32``/``file_size``), verified *before*
    deserializing, so a truncated or bit-flipped file is rejected with
    :class:`CheckpointCorruptError` instead of a numpy parse error or
    garbage;
  * placement on restore: every leaf lands on the ``device`` the restoring
    caller names, as a tensor of the target leaf's dtype;
  * async save: the copy to the host is taken at once (snapshot
    semantics), the file I/O runs on a worker thread;
  * GC: keep the latest ``keep`` checkpoints.

Leaf names are the reference's (``_leaf_name`` of a ``jax.tree_util``
path, parts joined by ``__``), so either package reads the other's
checkpoints. Without ``jax.tree_util`` the store flattens trees itself, as
JAX flattens them: a dict in sorted key order under its keys, a tuple or
list by index, ``None`` as no leaf, a node that
has ``tree_flatten`` (the engine's ``GAState``, ``Problem``, ``GeneTable``
and ``EvalCache``) by the index of each child in its ``tree_flatten``
order, and anything else (a tensor, a NumPy array or scalar, a Python
number) as one leaf.

Recovery code never trusts a single step blindly:
:func:`verify_checkpoint` checks a whole step without a restore target,
and :func:`latest_valid_step` walks steps newest to oldest to the most
recent one that verifies. A crash mid-write leaves only a ``.tmp``
directory (invisible to :func:`latest_step`), and damage after the commit
(bit rot, truncation) skips back to the previous commit.
"""
from __future__ import annotations

import io
import json
import os
import re
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

from ..device import device_of


class CheckpointCorruptError(IOError):
    """A checkpoint failed integrity verification (truncated file, crc
    mismatch, unreadable manifest, missing leaf). Restores raise this
    instead of whatever deserialization error the damage would cause;
    recovery code catches it and falls back to an older step."""


def _is_node(x) -> bool:
    return hasattr(x, "tree_flatten") and hasattr(type(x), "tree_unflatten")


def named_leaves(tree, path: tuple = ()):
    """(name, leaf) of every leaf of ``tree`` in JAX's flatten order, named
    as the reference's ``_leaf_name`` names them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, path + (str(i),))
    elif _is_node(tree):
        for i, c in enumerate(tree.tree_flatten()[0]):
            yield from named_leaves(c, path + (str(i),))
    else:
        yield "__".join(path) or "root", tree


def _map_leaves(fn, tree, path: tuple = ()):
    """``tree`` rebuilt with each leaf replaced by ``fn(name, leaf)``: new
    containers and new engine objects (``tree_unflatten``) throughout."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    if _is_node(tree):
        children, aux = tree.tree_flatten()
        return type(tree).tree_unflatten(
            aux, [_map_leaves(fn, c, path + (str(i),)) for i, c in enumerate(children)])
    return fn("__".join(path) or "root", tree)


def _host(x) -> np.ndarray:
    """A leaf as a host array of its own (a copy: later writes to the
    tensor do not reach the snapshot)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def save_checkpoint(directory: str, step: int, state, *, keep: int = 3,
                    async_io: bool = False) -> str:
    """Snapshot ``state`` (to the host now), write its files (on a worker
    thread with ``async_io``) and commit them with one rename."""
    os.makedirs(directory, exist_ok=True)
    host = [(name, _host(x)) for name, x in named_leaves(state)]

    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"

    def _write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for name, arr in host:
            raw = _npy_bytes(arr)
            with open(os.path.join(tmp, name + ".npy"), "wb") as f:
                f.write(raw)
            manifest["leaves"][name] = {
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF,
                # the raw file's twin of the payload crc: verified BEFORE
                # np.load, so damage anywhere in the file (header included)
                # is caught without deserializing
                "file_crc32": zlib.crc32(raw) & 0xFFFFFFFF,
                "file_size": len(raw),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic commit
        _gc(directory, keep)

    if async_io:
        threading.Thread(target=_write, daemon=True).start()
        return final
    _write()
    return final


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory) if re.fullmatch(r"step_\d+", d))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    """All committed checkpoint steps under ``directory``, ascending.
    ``.tmp`` directories (uncommitted two-phase writes) never appear."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if re.fullmatch(r"step_\d+", d))


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _load_manifest(directory: str, step: int) -> dict:
    d = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} under {directory} has no manifest "
            "(partial write?)") from e
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint step {step} under {directory}: unreadable "
            f"manifest: {e}") from e


def _read_leaf_file(d: str, name: str, meta: dict, verify: bool) -> np.ndarray:
    """Read one leaf ``.npy``, verifying its raw bytes before parsing them."""
    fn = os.path.join(d, name + ".npy")
    try:
        with open(fn, "rb") as f:
            raw = f.read()
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"checkpoint leaf {name!r} missing ({fn})") from e
    if verify and "file_size" in meta:
        if len(raw) != meta["file_size"]:
            raise CheckpointCorruptError(
                f"checkpoint corruption in leaf {name!r}: file is {len(raw)} bytes, "
                f"manifest says {meta['file_size']} (truncated write?)")
        crc = zlib.crc32(raw) & 0xFFFFFFFF
        if crc != meta["file_crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint corruption in leaf {name!r}: file crc {crc} != "
                f"{meta['file_crc32']} (bit-flipped file)")
    try:
        arr = np.load(io.BytesIO(raw))
    except Exception as e:           # manifests without file_crc32 only
        raise CheckpointCorruptError(
            f"checkpoint leaf {name!r} failed to deserialize: {e}") from e
    if verify:
        crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
        if crc != meta["crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint corruption in leaf {name!r}: payload crc {crc} != "
                f"{meta['crc32']}")
    return arr


def verify_checkpoint(directory: str, step: int) -> dict:
    """Verify EVERY leaf of one committed checkpoint (sizes and crcs).

    Raises :class:`CheckpointCorruptError` on the first damaged leaf;
    returns the manifest when the whole step is intact. It needs no
    restore target, so recovery can vet a step before knowing its tree."""
    manifest = _load_manifest(directory, step)
    d = os.path.join(directory, f"step_{step:08d}")
    for name, meta in manifest["leaves"].items():
        _read_leaf_file(d, name, meta, verify=True)
    return manifest


def latest_valid_step(directory: str) -> Optional[int]:
    """The newest step that passes :func:`verify_checkpoint`, the restore
    point of crash recovery: damaged steps are skipped, newest first; None
    when no step verifies."""
    for step in reversed(list_steps(directory)):
        try:
            verify_checkpoint(directory, step)
            return step
        except CheckpointCorruptError:
            continue
    return None


def read_leaf(directory: str, step: int, name: str, *, verify: bool = True) -> np.ndarray:
    """ONE named leaf of a checkpoint as a host array, without a target.

    ``name`` is the manifest key (e.g. ``"2"`` for the third element of a
    top-level tuple). This is the bootstrap read of two-phase restores:
    ``repro_torch.serve.SearchServer`` keeps its host-side scheduler
    metadata as a uint8 JSON leaf inside the saved tree (so the commit
    rename covers it), reads it back with this, and only then knows the
    lane and segment geometry of the restore target."""
    manifest = _load_manifest(directory, step)
    if name not in manifest["leaves"]:
        raise CheckpointCorruptError(
            f"checkpoint step {step} has no leaf {name!r} "
            f"(leaves: {sorted(manifest['leaves'])})")
    d = os.path.join(directory, f"step_{step:08d}")
    return _read_leaf_file(d, name, manifest["leaves"][name], verify)


def _numpy_dtype(target, fallback: np.dtype) -> np.dtype:
    """The numpy dtype a target leaf asks for: a tensor's, an array's (or
    a ``ShapeDtypeStruct``-like ``.dtype``'s), else the file's."""
    if isinstance(target, torch.Tensor):
        return torch.empty(0, dtype=target.dtype).numpy().dtype
    dt = getattr(target, "dtype", None)
    return fallback if dt is None else np.dtype(dt)


def restore_checkpoint(directory: str, step: int, target, *, device="cuda",
                       verify: bool = True):
    """Restore into the structure of ``target`` (a tree of tensors, arrays
    or anything with a ``dtype``): every leaf comes back as a tensor on
    ``device`` (the card unless the CPU is asked for), cast to the target
    leaf's dtype, in new containers and new engine objects."""
    dev = device_of(device)
    manifest = _load_manifest(directory, step)
    d = os.path.join(directory, f"step_{step:08d}")

    def load(name, tgt):
        if name not in manifest["leaves"]:
            raise CheckpointCorruptError(
                f"checkpoint step {step} has no leaf {name!r} the restore target "
                "expects (incompatible or damaged manifest)")
        arr = _read_leaf_file(d, name, manifest["leaves"][name], verify)
        arr = arr.astype(_numpy_dtype(tgt, arr.dtype))
        return torch.from_numpy(arr).to(dev)

    return _map_leaves(load, target)


class CheckpointManager:
    """Train-loop facing wrapper: periodic saves (async by default) and a
    restore of the latest step."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3,
                 async_io: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.async_io = async_io

    def maybe_save(self, step: int, state) -> bool:
        if self.every and step % self.every == 0 and step > 0:
            save_checkpoint(self.directory, step, state, keep=self.keep,
                            async_io=self.async_io)
            return True
        return False

    def restore_latest(self, target, device="cuda"):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, target, device=device)
