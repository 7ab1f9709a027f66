"""The port's checkpoint store (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), in-process: the reference's store
compiles no program.

* Crash points of the two-phase commit: a kill between the tmp write and
  the rename, and a kill after a partial tmp write, leave the last
  committed step restorable and the ``.tmp`` directory invisible.
* Integrity: truncation and bit flips (the port's ``corrupt_checkpoint``,
  which damages the same byte as the reference's), ``latest_valid_step``
  skipping back, manifest rot, a missing leaf, ``_gc``.
* Both directions: the port's store written from the reference test's dict
  payload is read by the reference's ``verify_checkpoint`` and
  ``restore_checkpoint``, and the other way round; both write equal
  ``manifest.json`` leaves (names, shapes, dtypes, ``crc32``,
  ``file_crc32``, ``file_size``) and equal leaf files.
* Leaf names: the port's flatten names every leaf as ``jax.tree_util``'s
  paths do, for plain trees and for the engine's ``GAState`` and
  ``EvalCache``.

Values are held bit for bit.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_manager
from repro.core.dedup import EvalCache as RefEvalCache
from repro.core.engine import GAState as RefGAState
from repro.serve.chaos import corrupt_checkpoint as ref_corrupt_checkpoint
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointManager, latest_step,
                                    latest_valid_step, list_steps, restore_checkpoint,
                                    save_checkpoint, verify_checkpoint)
from repro_torch.checkpoint import manager
from repro_torch.core.dedup import EvalCache
from repro_torch.core.engine import GAState
from repro_torch.serve.chaos import corrupt_checkpoint

CPU = dict(device="cpu")


def _payload(seed):
    """The reference test's payload (tests/test_checkpoint_faults.py)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "step_count": np.int64(seed),
            "ids": np.arange(seed + 4, dtype=np.int32)}


def _target():
    return {"w": torch.zeros((8, 16)), "step_count": torch.zeros((), dtype=torch.int64),
            "ids": torch.zeros(0, dtype=torch.int32)}


def _assert_restores(directory, step, seed):
    got = restore_checkpoint(directory, step, _target(), **CPU)
    want = _payload(seed)
    assert got["w"].dtype == torch.float32 and got["ids"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].numpy(), want["w"])
    np.testing.assert_array_equal(got["ids"].numpy(), want["ids"])
    assert int(got["step_count"]) == seed


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


# -- crash points ---------------------------------------------------------------------

def test_kill_between_tmp_write_and_rename(tmp_path, monkeypatch):
    """Every file of step 2 written, the process dies before the rename:
    the restore lands on committed step 1, the .tmp is invisible, and a
    later save of step 2 commits over the orphan."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _payload(1))

    def die(src, dst):
        raise OSError("killed between tmp write and rename")

    monkeypatch.setattr(os, "rename", die)
    with pytest.raises(OSError, match="killed between"):
        save_checkpoint(d, 2, _payload(2))
    monkeypatch.undo()
    assert os.path.isdir(os.path.join(d, "step_00000002.tmp"))
    assert list_steps(d) == [1] and latest_step(d) == 1 == latest_valid_step(d)
    _assert_restores(d, 1, 1)
    save_checkpoint(d, 2, _payload(2))
    assert latest_valid_step(d) == 2
    _assert_restores(d, 2, 2)


def test_kill_after_partial_tmp_write(tmp_path, monkeypatch):
    """Death mid-write: one leaf file of step 2, no manifest; the half
    written tmp never shadows committed step 1."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _payload(1))
    calls, real = {"n": 0}, manager._npy_bytes

    def die_after_first(arr):
        calls["n"] += 1
        if calls["n"] > 1:
            raise OSError("killed mid tmp write")
        return real(arr)

    monkeypatch.setattr(manager, "_npy_bytes", die_after_first)
    with pytest.raises(OSError, match="mid tmp write"):
        save_checkpoint(d, 2, _payload(2))
    monkeypatch.undo()
    tmp = os.path.join(d, "step_00000002.tmp")
    assert os.listdir(tmp) == ["ids.npy"]
    assert list_steps(d) == [1] and latest_valid_step(d) == 1
    _assert_restores(d, 1, 1)


# -- integrity ------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["truncate", "bitflip"])
def test_damaged_leaf_rejected_with_clear_error(tmp_path, kind):
    d = str(tmp_path)
    save_checkpoint(d, 1, _payload(1))
    corrupt_checkpoint(d, 1, kind=kind, leaf="w", seed=3)
    with pytest.raises(CheckpointCorruptError, match="leaf 'w'"):
        verify_checkpoint(d, 1)
    with pytest.raises(CheckpointCorruptError, match="truncated|bit-flipped|crc"):
        restore_checkpoint(d, 1, _target(), **CPU)
    assert latest_valid_step(d) is None


@pytest.mark.parametrize("kind", ["truncate", "bitflip"])
def test_latest_valid_step_skips_damaged(tmp_path, kind):
    """Rot after the commit of the newest step: recovery falls back to the
    previous intact step."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _payload(1))
    save_checkpoint(d, 2, _payload(2))
    corrupt_checkpoint(d, 2, kind=kind, seed=5)
    assert latest_step(d) == 2 and latest_valid_step(d) == 1
    _assert_restores(d, 1, 1)


@pytest.mark.parametrize("kind", ["truncate", "bitflip"])
@pytest.mark.parametrize("leaf", [None, "ids"])
def test_corruption_damages_the_references_byte(tmp_path, kind, leaf):
    """Both packages' ``corrupt_checkpoint`` pick the same file (the largest
    by default) and damage it the same way: the files are equal after."""
    for sub in ("port", "ref"):
        save_checkpoint(str(tmp_path / sub), 3, _payload(3))
    fn = corrupt_checkpoint(str(tmp_path / "port"), 3, kind=kind, leaf=leaf, seed=7)
    ref_fn = ref_corrupt_checkpoint(str(tmp_path / "ref"), 3, kind=kind, leaf=leaf, seed=7)
    assert os.path.basename(fn) == os.path.basename(ref_fn) == f"{leaf or 'w'}.npy"
    with open(fn, "rb") as a, open(ref_fn, "rb") as b:
        assert a.read() == b.read()


def test_manifest_rot_and_missing_leaf_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _payload(1))
    save_checkpoint(d, 2, _payload(2))
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        verify_checkpoint(d, 2)
    assert latest_valid_step(d) == 1
    os.remove(os.path.join(d, "step_00000001", "ids.npy"))
    with pytest.raises(CheckpointCorruptError, match="missing"):
        verify_checkpoint(d, 1)
    assert latest_valid_step(d) is None
    with pytest.raises(CheckpointCorruptError, match="no leaf 'nope'"):
        manager.read_leaf(d, 1, "nope")


def test_corrupt_kind_validated(tmp_path):
    save_checkpoint(str(tmp_path), 1, _payload(1))
    with pytest.raises(ValueError, match="kind"):
        corrupt_checkpoint(str(tmp_path), 1, kind="arson")


def test_gc_keeps_the_latest(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, _payload(s), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]
    assert list_steps(str(tmp_path)) == [4, 5] and list_steps(str(tmp_path / "none")) == []


def test_async_save_is_a_snapshot_and_the_manager_saves_every_n(tmp_path):
    """The host copy is taken when ``save_checkpoint`` is called: writes to
    the tensor after it returns do not reach the files the worker thread
    writes. ``CheckpointManager`` saves at multiples of ``every`` and
    restores the latest."""
    d = str(tmp_path)
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    threads = set(threading.enumerate())
    save_checkpoint(d, 1, {"w": w}, async_io=True)
    w += 100
    for t in set(threading.enumerate()) - threads:
        t.join(30)
    got = restore_checkpoint(d, 1, {"w": torch.zeros(3, 4)}, **CPU)
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(12).reshape(3, 4))
    mgr = CheckpointManager(str(tmp_path / "mgr"), every=2, keep=2, async_io=False)
    assert mgr.restore_latest(_target(), **CPU) == (None, None)
    assert [mgr.maybe_save(s, _payload(s)) for s in range(5)] == [False, False, True,
                                                                  False, True]
    step, got = mgr.restore_latest(_target(), **CPU)
    assert step == 4 and int(got["step_count"]) == 4


# -- both directions against the reference's store -----------------------------------

def test_port_and_reference_write_the_same_files(tmp_path):
    """The reference test's payload through both stores: equal manifests
    (every leaf's name, shape, dtype, crc32, file_crc32, file_size) and
    equal leaf files, byte for byte."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(port, 9, _payload(9))
    ref_manager.save_checkpoint(ref, 9, _payload(9))
    assert _manifest(port, 9) == _manifest(ref, 9)
    for name in _manifest(ref, 9)["leaves"]:
        with open(os.path.join(port, "step_00000009", name + ".npy"), "rb") as a, \
                open(os.path.join(ref, "step_00000009", name + ".npy"), "rb") as b:
            assert a.read() == b.read(), name


def test_each_package_reads_the_others_checkpoint(tmp_path):
    """The port's checkpoint verifies and restores in the reference's store,
    the reference's in the port's, and damage to either is caught by
    the other."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(port, 4, _payload(4))
    ref_manager.save_checkpoint(ref, 4, _payload(4))
    assert ref_manager.verify_checkpoint(port, 4)["step"] == 4
    got = ref_manager.restore_checkpoint(port, 4, _payload(0))
    want = _payload(4)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert verify_checkpoint(ref, 4)["step"] == 4
    _assert_restores(ref, 4, 4)
    corrupt_checkpoint(ref, 4, kind="bitflip", seed=1)
    ref_corrupt_checkpoint(port, 4, kind="truncate", seed=1)
    assert latest_valid_step(ref) is None and ref_manager.latest_valid_step(port) is None


def _ref_names(tree):
    return [ref_manager._leaf_name(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_leaf_names_are_jaxs():
    """Dicts in sorted key order, tuples and lists by index, None as no
    leaf, NumPy scalars and arrays as one leaf each: the port's names and
    order are the reference's."""
    tree = {"b": (np.zeros(2), [np.int32(1), None, {"z": np.ones(1), "a": np.zeros(3)}]),
            "a": (np.float32(0.5), (np.zeros((2, 2)),)), "c": None, "3": np.arange(2)}
    assert [n for n, _ in manager.named_leaves(tree)] == _ref_names(tree)
    assert [n for n, _ in manager.named_leaves(np.zeros(3))] == ["root"] == _ref_names(np.zeros(3))


@pytest.mark.parametrize("cached", [True, False])
def test_engine_leaf_names_are_the_references(tmp_path, cached):
    """A port ``GAState`` (int64 key words) and the reference's over the same
    values: the same leaf names in the same order (the cache as
    ``8__{0,1,2}``, no cache leaves when dedup is off), and with the key
    written as uint32 the same files; each restores into the other's
    structure."""
    rng = np.random.default_rng(0)
    L, P, G, C = 2, 4, 5, 8
    arrays = dict(pop=rng.integers(0, 9, (L, P, G)).astype(np.int32),
                  obj=rng.random((L, P, 2)).astype(np.float32),
                  viol=rng.random((L, P)).astype(np.float32),
                  rank=rng.integers(0, 3, (L, P)).astype(np.int32),
                  crowd=rng.random((L, P)).astype(np.float32),
                  counts=rng.integers(0, 50, (L, P)).astype(np.int32),
                  key=rng.integers(0, 2**32, (L, 2), dtype=np.uint64).astype(np.uint32),
                  gen=np.full(L, 7, np.int32))
    cache = ((rng.integers(0, 9, (L, C, G)).astype(np.int32),
              rng.integers(0, 50, (L, C)).astype(np.int32),
              rng.integers(-1, 7, (L, C)).astype(np.int32)) if cached else None)
    ref = RefGAState(**arrays, cache=RefEvalCache(*cache) if cached else None)
    port = GAState(**{k: torch.from_numpy(v.astype(np.int64) if k == "key" else v)
                      for k, v in arrays.items()},
                   cache=EvalCache(*map(torch.from_numpy, cache)) if cached else None)
    names = [n for n, _ in manager.named_leaves((port, None, np.zeros(0, np.uint8)))]
    assert names == _ref_names((ref, None, np.zeros(0, np.uint8)))
    assert names[6:8] == ["0__6", "0__7"] and ("0__8__2" in names) == cached
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_manager.save_checkpoint(ref_dir, 1, (ref,))
    save_checkpoint(port_dir, 1, (GAState(**{**port.__dict__, "key": port.key.numpy().astype(
        np.uint32)}),))
    assert _manifest(port_dir, 1) == _manifest(ref_dir, 1)
    (back,) = restore_checkpoint(ref_dir, 1, (port,), **CPU)
    assert isinstance(back, GAState) and back is not port and back.key.dtype == torch.int64
    for (name, a), (_, b) in zip(manager.named_leaves(back), manager.named_leaves(port)):
        assert torch.equal(a, b), name
    (ref_back,) = ref_manager.restore_checkpoint(port_dir, 1, (ref,))
    for a, b in zip(jax.tree_util.tree_leaves(ref_back), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_places_every_leaf_as_a_tensor_of_the_targets_dtype(tmp_path):
    """NumPy and tensor targets alike come back as tensors on the asked
    device, cast to the target's dtype; a missing leaf raises."""
    d = str(tmp_path)
    save_checkpoint(d, 2, {"k": np.array([1, 2**32 - 1], np.uint32), "x": np.arange(3.0)})
    got = restore_checkpoint(d, 2, {"k": torch.zeros(2, dtype=torch.int64),
                                    "x": np.zeros(3, np.float32)}, **CPU)
    assert got["k"].tolist() == [1, 2**32 - 1] and got["x"].dtype == torch.float32
    assert got["k"].device.type == "cpu"
    with pytest.raises(CheckpointCorruptError, match="no leaf 'y'"):
        restore_checkpoint(d, 2, {"y": np.zeros(1)}, **CPU)
