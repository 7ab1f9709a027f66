"""The port's supervised search server (``repro_torch.serve`` A12b:
``Supervisor``, ``FaultPolicy``, ``ChaosPlan``) and the server's
checkpoints, bit for bit (tolerance 0 on int32 and float32):

* against the port's ``GATrainer.run`` and the bare port ``SearchServer``
  (themselves held against the reference by tests/test_torch_trainer.py and
  tests/test_torch_serve.py): default-policy parity, mid-flight save and
  restore under dedup on and off, ``allow_pending`` with resubmission, the
  headline chaos schedule of tests/test_chaos.py, exact quarantine of each
  poison leaf (nominal and device variation), retry, backoff, kills,
  fire-once, the watchdog, ``quarantine=False``, ``patience`` retirement
  and ``backend_fallback`` kept off (True is refused);
* against the reference's ``Supervisor``/``SearchServer``: ONE subprocess
  saves the reference's stream mid-flight, drains the port's checkpoint of
  the same stream, runs the chaos schedule and a ``patience`` stream, and
  writes every ``JobResult`` field, ``stats``, ``recovered_step``,
  ``dropped_pending`` and each committed step's manifest. No reference
  server or supervisor runs in this process (ROADMAP C8).

The problems are the reference tests' ``_make`` data, pop 16, 2 lanes.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
import warnings

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine
from repro_torch.core.interop import state_to_numpy
from repro_torch.kernels.backend import BackendPolicy
from repro_torch.serve import (ChaosIOError, ChaosKill, ChaosPlan, FaultPolicy,
                               LaneValidationError, SearchServer, SegmentFault,
                               SegmentTimeoutError, Supervisor)
from test_torch_interop import STATE_FIELDS, assert_bits_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
RESULT_FIELDS = ("generations", "unique_evals", "cache_hits", "admitted_segment",
                 "retired_segment", "generations_run", "ok", "converged")
FRONT_FIELDS = ("objectives", "indices", "genomes")

# (seed, samples, sizes) of the reference tests' two problems and their easy one
PROBLEMS = {"a": (1, 64, (4, 4, 2)), "b": (2, 96, (5, 6, 2)), "easy": (3, 32, (3, 3, 2))}
# the mid-flight stream: the third job still queued when the save is taken
CKPT_JOBS = [("a", 8, 0, "a-8"), ("b", 8, 1, "b-8"), ("a", 4, 2, "a-4")]
# tests/test_chaos.py:68, the headline schedule
CHAOS_JOBS = [("a", 32, 0, "victim"), ("b", 24, 1, "long"), ("a", 8, 2, "late")]
CHAOS = dict(io_errors=(1,), poison={1: 0}, poison_leaf="obj", corrupt_steps=(4,),
             corrupt_kind="bitflip", kill_after_segment=4)
# a-32 converges (patience 1) after 20 generations, while b-8 and then a-8
# run beside it
PATIENCE_JOBS = [("a", 32, 0, "a-32"), ("b", 8, 1, "b-8"), ("a", 8, 2, "a-8")]
LANES = dict(n_lanes=2, segment_len=4)

REFERENCE = """
    import json, os, sys
    import numpy as np
    from repro.core import GAConfig, engine
    from repro.core.genome import MLPTopology
    from repro.checkpoint import manager
    from repro.serve import ChaosKill, ChaosPlan, FaultPolicy, SearchServer, Supervisor

    out, port_ckpt = sys.argv[1], sys.argv[2]
    problems, ckpt_jobs, chaos_jobs, chaos, patience_jobs, lanes = (
        json.loads(a) for a in sys.argv[3:9])
    chaos["poison"] = {int(k): v for k, v in chaos["poison"].items()}

    def make(seed, n, sizes):
        rng = np.random.default_rng(seed)
        x = rng.random((n, sizes[0])).astype(np.float32)
        y = (x.sum(axis=1) > sizes[0] / 2).astype(np.int32)
        return MLPTopology(tuple(sizes)), x, y

    cfg = GAConfig(pop_size=16, generations=8)
    probs = {k: engine.Problem.from_data(*make(*v), cfg) for k, v in problems.items()}
    byname = {}
    leaves, meta = {}, {}

    def submit(target, jobs):
        for p, g, s, name in jobs:
            byname[name] = p
            target.submit(probs[p], generations=g, seed=s, name=name)

    def resubmit(target):
        for m in target.dropped_pending:
            target.submit(probs[byname[m["name"]]], generations=m["generations"],
                          seed=m["seed"], name=m["name"])

    def record(tag, results):
        for r in results:
            p = f"{tag}/{r.name}/"
            for f in ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen"):
                leaves[p + f] = np.asarray(getattr(r.state, f))
            for f in ("objectives", "indices", "genomes") if r.front is not None else ():
                leaves[p + "front." + f] = np.asarray(r.front[f])
            for f in ("generations", "unique_evals", "cache_hits", "admitted_segment",
                      "retired_segment", "generations_run", "ok", "converged"):
                leaves[p + f] = np.asarray(getattr(r, f))
            leaves[p + "job_id"] = np.asarray(r.job_id)
            leaves[p + "error"] = np.asarray(str(r.error))

    def manifests(d):
        return {s: json.load(open(os.path.join(d, f"step_{s:08d}", "manifest.json")))
                for s in manager.list_steps(d)}

    # 1. the mid-flight stream: saved after one segment, then drained
    srv = SearchServer.for_problems([probs["a"], probs["b"]], policy="longest", **lanes)
    submit(srv, ckpt_jobs)
    srv.step()
    ref_ckpt = os.path.join(out, "ref_ckpt")
    srv.save(ref_ckpt, allow_pending=True)
    meta["ckpt_manifests"] = manifests(ref_ckpt)
    record("uninterrupted", srv.drain())

    def same_server():
        # Supervisor.for_problems's server, on the first server's GenomeSpec
        # object: the reference's compiled segment is cached per spec object
        return SearchServer(srv.spec, cfg, max_samples=srv.max_samples, policy="longest",
                            **lanes)

    # 2. the port's checkpoint of the same stream, restored and drained
    rest = SearchServer.restore(port_ckpt, srv.spec, cfg)
    meta["from_port_pending"] = rest.dropped_pending
    resubmit(rest)
    record("from_port", rest.drain())
    # 3. the chaos schedule, recovered in the same process
    chaos_dir = os.path.join(out, "ref_chaos")
    sup = Supervisor(same_server(), FaultPolicy(checkpoint_every=2, backoff_base_s=0.0),
                     directory=chaos_dir, chaos=ChaosPlan(**chaos), sleep=lambda s: None)
    submit(sup, chaos_jobs)
    results = []
    try:
        while sup.server.has_work:
            results.extend(sup.step())
        raise AssertionError("no kill")
    except ChaosKill:
        pass
    meta["chaos_killed_stats"] = sup.stats
    meta["chaos_kill_manifests"] = manifests(chaos_dir)
    sup2 = Supervisor.recover(chaos_dir, sup.server.spec, cfg, FaultPolicy(checkpoint_every=2))
    meta["recovered_step"] = sup2.recovered_step
    meta["dropped_pending"] = sup2.dropped_pending
    resubmit(sup2)
    results.extend(sup2.drain())
    record("chaos", results)
    meta["chaos_stats"] = sup2.stats
    meta["chaos_end_manifests"] = manifests(chaos_dir)
    # 4. patience retirement
    sup = Supervisor(same_server(), FaultPolicy(patience=1))
    submit(sup, patience_jobs)
    record("patience", sup.drain())
    meta["patience_stats"] = sup.stats
    np.savez(os.path.join(out, "results.npz"), **leaves)
    json.dump(meta, open(os.path.join(out, "meta.json"), "w"))
"""


def _make(seed, n, sizes):
    rng = np.random.default_rng(seed)
    x = rng.random((n, sizes[0])).astype(np.float32)
    y = (x.sum(axis=1) > sizes[0] / 2).astype(np.int32)
    return MLPTopology(tuple(sizes)), x, y


DATA = {k: _make(*v) for k, v in PROBLEMS.items()}


def _problems(**cfg_kw):
    cfg = GAConfig(pop_size=16, generations=8, **cfg_kw)
    return {k: engine.Problem.from_data(*DATA[k], cfg, **CPU) for k in DATA}, cfg


@functools.lru_cache(maxsize=None)
def _trainer(name, seed, generations, cfg):
    tr = GATrainer(*DATA[name], dataclasses.replace(cfg, seed=seed, generations=generations),
                   **CPU)
    state, _ = tr.run()
    return tr, state


def assert_same_state(a, b, msg, cache=False):
    a, b = state_to_numpy(a), state_to_numpy(b)
    names = STATE_FIELDS + (("cache.rows", "cache.vals", "cache.stamp") if cache else ())
    for f in names:
        assert_bits_equal(b[f], a[f], f"{msg}: GAState.{f}")


def assert_matches_trainer(r, name, seed, cfg):
    """A healthy result equals the port's trainer at its generations_run."""
    assert r.ok, r.error
    tr, state = _trainer(name, seed, r.generations_run, cfg)
    assert_same_state(r.state, state, r.name)
    assert (r.unique_evals, r.cache_hits) == (tr.unique_evals, tr.cache_hits), r.name
    want = tr.front(state)
    for k in FRONT_FIELDS:
        assert_bits_equal(want[k], r.front[k], f"{r.name}: front {k}")


def assert_same_results(a, b, msg):
    """Two port JobResults, every field."""
    assert_same_state(a.state, b.state, msg)
    for f in RESULT_FIELDS + ("job_id", "name", "error"):
        assert getattr(a, f) == getattr(b, f), f"{msg}: {f}"
    assert (a.front is None) == (b.front is None), msg
    for k in FRONT_FIELDS if a.front is not None else ():
        assert_bits_equal(a.front[k], b.front[k], f"{msg}: front {k}")


def _submit(target, probs, jobs):
    for p, g, s, name in jobs:
        target.submit(probs[p], generations=g, seed=s, name=name)


def _resubmit(target, probs, jobs):
    by_name = {name: p for p, _, _, name in jobs}
    for m in target.dropped_pending:
        target.submit(probs[by_name[m["name"]]], generations=m["generations"],
                      seed=m["seed"], name=m["name"])


def _chaos_run(directory, probs, cfg, sleeps=None):
    """The headline chaos schedule on the port → (results by name, the
    killed supervisor, the recovered one, the manifests at the kill)."""
    sup = Supervisor.for_problems(
        [probs["a"], probs["b"]], FaultPolicy(checkpoint_every=2, backoff_base_s=0.0),
        directory=str(directory), chaos=ChaosPlan(**CHAOS),
        sleep=sleeps.append if sleeps is not None else (lambda s: None),
        scheduler_policy="longest", **LANES)
    _submit(sup, probs, CHAOS_JOBS)
    results = {}
    with pytest.raises(ChaosKill):
        while sup.server.has_work:
            results.update((r.name, r) for r in sup.step())
    at_kill = _manifests(directory)
    sup2 = Supervisor.recover(str(directory), sup.server.spec, cfg,
                              FaultPolicy(checkpoint_every=2), **CPU)
    recovered = (sup2.recovered_step, list(sup2.dropped_pending))
    _resubmit(sup2, probs, CHAOS_JOBS)
    results.update((r.name, r) for r in sup2.drain())
    return results, sup, sup2, recovered, at_kill


def _patience_run(probs):
    sup = Supervisor.for_problems([probs["a"], probs["b"]], FaultPolicy(patience=1),
                                  scheduler_policy="longest", **LANES)
    _submit(sup, probs, PATIENCE_JOBS)
    return {r.name: r for r in sup.drain()}, sup


def _manifests(directory) -> dict:
    out = {}
    for s in manager.list_steps(str(directory)):
        with open(os.path.join(str(directory), f"step_{s:08d}", "manifest.json")) as f:
            out[str(s)] = json.load(f)
    return out


# -- against the port's trainer and bare server -------------------------------------

@pytest.mark.parametrize("every", [0, 2])
def test_faultfree_supervised_parity(tmp_path, every):
    """The default policy (validation on, nothing else) and checkpoints every
    2 segments, no faults: every job is healthy and equals its trainer and
    the bare server's result; every committed step verifies."""
    probs, cfg = _problems()
    jobs = [("a", 8, 0, "j0"), ("b", 12, 1, "j1"), ("a", 4, 2, "j2")]
    policy = FaultPolicy(checkpoint_every=every) if every else None
    sup = Supervisor.for_problems([probs["a"], probs["b"]], policy,
                                  directory=str(tmp_path) if every else None, **LANES)
    _submit(sup, probs, jobs)
    results = {r.name: r for r in sup.drain()}
    bare = SearchServer.for_problems([probs["a"], probs["b"]], **LANES)
    _submit(bare, probs, jobs)
    bare_results = {r.name: r for r in bare.drain()}
    assert sup.stats == {"segments": bare.segments_done, "retries": 0,
                         "checkpoints": bare.segments_done // 2 if every else 0,
                         "quarantined": 0, "converged": 0}
    assert len(manager.list_steps(str(tmp_path))) == (min(3, bare.segments_done // 2)
                                                      if every else 0)
    for p, g, s, name in jobs:
        r = results[name]
        assert r.ok and r.error is None and not r.converged and r.generations_run == g
        assert_matches_trainer(r, p, s, cfg)
        assert_same_results(r, bare_results[name], name)
    for step in manager.list_steps(str(tmp_path)):
        manager.verify_checkpoint(str(tmp_path), step)


def test_checkpointing_requires_directory():
    probs, _ = _problems()
    srv = SearchServer.for_problems([probs["a"]], n_lanes=1, **CPU)
    with pytest.raises(ValueError, match="directory"):
        Supervisor(srv, FaultPolicy(checkpoint_every=2))


@pytest.mark.parametrize("dedup", [True, False])
def test_mid_flight_save_restore_is_bit_identical(tmp_path, dedup):
    """Both jobs in flight mid-budget: the restored server (new Problem and
    GAState objects, the EvalCache and every problem leaf restored) drains
    to the uninterrupted run's results, every field."""
    probs, cfg = _problems(dedup=dedup)
    jobs = [("a", 12, 3, "a"), ("b", 8, 4, "b")]
    srv = SearchServer.for_problems([probs["a"], probs["b"]], **LANES)
    _submit(srv, probs, jobs)
    assert srv.step() == []
    srv.save(str(tmp_path))
    rest = SearchServer.restore(str(tmp_path), srv.spec, cfg, **CPU)
    assert (rest.segments_done, rest.active_jobs) == (srv.segments_done, srv.active_jobs)
    # new objects: nothing memoized on the constructor's lanes survives
    assert not {"_lanes", "_subsets"} & set(rest._problems.__dict__)
    assert_same_state(rest._states, srv._states, "restored lanes", cache=dedup)
    for a, b in zip(manager.named_leaves(rest._problems), manager.named_leaves(srv._problems)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert_bits_equal(b[1], a[1], f"problem leaf {a[0]}")
    resumed = {r.name: r for r in rest.drain()}
    control = {r.name: r for r in srv.drain()}
    for _, _, _, name in jobs:
        assert_same_results(resumed[name], control[name], name)
    for p, _, s, name in jobs:
        assert_matches_trainer(resumed[name], p, s, cfg)


def test_allow_pending_save_and_resubmission(tmp_path):
    """A save while a job queues raises unless ``allow_pending``; then the
    queued job comes back in ``dropped_pending`` and, resubmitted, finishes
    equal to its trainer."""
    probs, cfg = _problems()
    srv = SearchServer.for_problems([probs["a"], probs["b"]], n_lanes=1, segment_len=4, **CPU)
    srv.submit(probs["a"], generations=8, seed=0, name="running")
    queued = srv.submit(probs["b"], generations=4, seed=1, name="queued")
    srv.step()
    with pytest.raises(ValueError, match="pending"):
        srv.save(str(tmp_path))
    srv.save(str(tmp_path), allow_pending=True)
    restored = SearchServer.restore(str(tmp_path), srv.spec, cfg, **CPU)
    assert restored.dropped_pending == [{"job_id": queued, "name": "queued",
                                         "generations": 4, "seed": 1}]
    _resubmit(restored, probs, [("b", 4, 1, "queued")])
    results = {r.name: r for r in restored.drain()}
    assert_matches_trainer(results["running"], "a", 0, cfg)
    assert_matches_trainer(results["queued"], "b", 1, cfg)


def test_restore_refuses_other_configs(tmp_path):
    """A config other than the saved one raises, and so does a checkpoint
    whose server ran a backend the port does not have ("interpret")."""
    probs, cfg = _problems()
    srv = SearchServer.for_problems([probs["a"]], n_lanes=1, segment_len=2, **CPU)
    srv.submit(probs["a"], generations=4)
    srv.step()
    d = str(tmp_path)
    srv.save(d)
    with pytest.raises(ValueError, match="cfg"):
        SearchServer.restore(d, srv.spec, dataclasses.replace(cfg, mutation_rate_gene=0.05),
                             **CPU)
    # the same checkpoint with its meta naming the reference's Pallas
    # interpreter: rewritten as a save would write it
    meta = json.loads(bytes(manager.read_leaf(d, 1, "2")))
    meta["cfg"] = meta["cfg"].replace("fitness='auto'", "fitness='interpret'")
    payload = {name: manager.read_leaf(d, 1, name)
               for name in _manifests(d)["1"]["leaves"]}
    payload["2"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    other = str(tmp_path / "other")
    manager.save_checkpoint(other, 1, payload)
    with pytest.raises(ValueError, match="fitness='interpret'"):
        SearchServer.restore(other, srv.spec, cfg, **CPU)


def test_full_fault_schedule_survived(tmp_path):
    """tests/test_chaos.py:68 on the port: the IO error retried, exactly the
    victim quarantined (NaN objectives, after 8 generations), recovery
    skipping the bit-rotted step 4 back to step 2 with "late" handed back in
    ``dropped_pending``, and every healthy job equal to its trainer."""
    probs, cfg = _problems()
    sleeps = []
    results, sup, sup2, (step, pending), _ = _chaos_run(tmp_path, probs, cfg, sleeps)
    assert sup.stats == {"segments": 5, "retries": 1, "checkpoints": 2, "quarantined": 1,
                         "converged": 0}
    assert sleeps == [0.0]
    victim = results["victim"]
    assert not victim.ok and victim.front is None and "finite_objectives" in victim.error
    assert victim.generations_run == 8 and torch.isnan(victim.state.obj).all()
    assert step == 2 and [p["name"] for p in pending] == ["late"]
    for p, g, s, name in CHAOS_JOBS[1:]:
        assert results[name].generations_run == g
        assert_matches_trainer(results[name], p, s, cfg)


@pytest.mark.parametrize("mode", ["off", "mean"])
@pytest.mark.parametrize("leaf,check", [("obj", "finite_objectives"),
                                        ("pop", "genome_in_bounds"),
                                        ("counts", "counts_in_range")])
def test_quarantine_is_exact(leaf, check, mode):
    """Whatever leaf is poisoned, nominal or under device variation ((P, 3)
    objectives, (P, K) counts), ONLY that lane's job fails, naming exactly
    its tripped check; the sibling equals its trainer."""
    kw = {} if mode == "off" else dict(variation_mode="mean", n_device_samples=3)
    probs, cfg = _problems(**kw)
    sup = Supervisor.for_problems([probs["a"], probs["b"]],
                                  chaos=ChaosPlan(poison={1: 0}, poison_leaf=leaf), **LANES)
    sup.submit(probs["a"], generations=16, seed=3, name="poisoned")
    sup.submit(probs["b"], generations=12, seed=4, name="healthy")
    results = {r.name: r for r in sup.drain()}
    bad = results["poisoned"]
    assert not bad.ok and bad.front is None and bad.generations_run == 8
    assert bad.error == f"lane 0 failed validation at segment 2: {check}"
    assert sup.stats["quarantined"] == 1
    assert_matches_trainer(results["healthy"], "b", 4, cfg)


def test_freed_quarantine_slot_backfills():
    probs, cfg = _problems()
    sup = Supervisor.for_problems([probs["a"]], chaos=ChaosPlan(poison={0: 0}, poison_leaf="pop"),
                                  n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=16, seed=0, name="poisoned")
    sup.submit(probs["a"], generations=8, seed=1, name="successor")
    results = {r.name: r for r in sup.drain()}
    assert not results["poisoned"].ok
    assert results["successor"].admitted_segment >= 1
    assert_matches_trainer(results["successor"], "a", 1, cfg)


def test_transient_segment_fault_retried_bit_identical():
    probs, cfg = _problems()
    sup = Supervisor.for_problems([probs["a"]], FaultPolicy(backoff_base_s=0.0),
                                  chaos=ChaosPlan(segment_faults=(0, 2)), sleep=lambda s: None,
                                  n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=16, seed=5, name="j")
    (r,) = sup.drain()
    assert sup.stats["retries"] == 2
    assert_matches_trainer(r, "a", 5, cfg)


def test_transient_io_error_retried(tmp_path):
    probs, _ = _problems()
    sup = Supervisor.for_problems([probs["a"]],
                                  FaultPolicy(checkpoint_every=2, backoff_base_s=0.0),
                                  directory=str(tmp_path), chaos=ChaosPlan(io_errors=(1,)),
                                  sleep=lambda s: None, n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=16, seed=0)
    sup.drain()
    assert (sup.stats["retries"], sup.stats["checkpoints"]) == (1, 2)
    assert manager.latest_valid_step(str(tmp_path)) == 4


def test_backoff_caps_and_exhausts():
    """The delays are base·2^k capped at backoff_cap_s, and a fault that
    outlasts max_retries propagates."""
    probs, _ = _problems()
    sleeps = []
    sup = Supervisor.for_problems(
        [probs["a"]], FaultPolicy(max_retries=4, backoff_base_s=0.1, backoff_cap_s=0.25),
        sleep=sleeps.append, n_lanes=1)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise SegmentFault("still down")
        return "up"

    assert sup._attempt(flaky) == "up"
    assert sleeps == [0.1, 0.2, 0.25] and sup.stats["retries"] == 3

    def dead():
        raise ChaosIOError("disk gone")

    with pytest.raises(ChaosIOError):
        sup._attempt(dead)
    assert sup.stats["retries"] == 7


def test_kill_and_in_dispatch_faults_are_not_retried(monkeypatch):
    """A kill propagates at once; so does an OSError raised inside the
    dispatch (the lane tensors may be half written), with no retry."""
    probs, _ = _problems()
    sup = Supervisor.for_problems([probs["a"]], chaos=ChaosPlan(kill_after_segment=0),
                                  n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=16, seed=0)
    with pytest.raises(ChaosKill):
        sup.drain()
    assert sup.stats["retries"] == 0
    sup = Supervisor.for_problems([probs["a"]], sleep=lambda s: None, n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=16, seed=0)
    calls = []

    def failing_step():
        calls.append(1)
        raise OSError("device lost mid-segment")

    monkeypatch.setattr(sup.server, "step", failing_step)
    with pytest.raises(OSError, match="mid-segment"):
        sup.step()
    assert calls == [1] and sup.stats["retries"] == 0


def test_fault_schedule_fires_once_and_poison_leaf_validated():
    plan = ChaosPlan(segment_faults=(3,))
    with pytest.raises(SegmentFault):
        plan.on_segment(3)
    plan.on_segment(3)                     # second call: silent
    plan.on_segment(4)                     # unscheduled: silent
    with pytest.raises(ValueError, match="poison_leaf"):
        ChaosPlan(poison_leaf="crowd")


def test_watchdog_times_out_hung_segment_and_keeps_the_callers_grad_mode(monkeypatch):
    """A hung ``step`` raises ``SegmentTimeoutError`` unretried; a healthy
    segment on the watchdog's thread runs under the caller's grad mode and
    equals the bare server's."""
    probs, cfg = _problems()
    sup = Supervisor.for_problems([probs["a"]], FaultPolicy(segment_timeout_s=30.0),
                                  n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=4, seed=0, name="j")
    seen, step = [], sup.server.step

    def watched():
        seen.append(torch.is_grad_enabled())
        return step()

    monkeypatch.setattr(sup.server, "step", watched)
    with torch.no_grad():
        (r,) = sup.step()
    assert seen == [False]
    assert_matches_trainer(r, "a", 0, cfg)
    sup = Supervisor.for_problems([probs["a"]], FaultPolicy(segment_timeout_s=0.05),
                                  n_lanes=1)
    sup.submit(probs["a"], generations=4, seed=0)
    monkeypatch.setattr(sup.server, "step", lambda: time.sleep(2))
    with pytest.raises(SegmentTimeoutError, match="watchdog"):
        sup.step()
    assert sup.stats["retries"] == 0


def test_quarantine_disabled_fails_loud():
    probs, _ = _problems()
    sup = Supervisor.for_problems([probs["a"]], FaultPolicy(quarantine=False),
                                  chaos=ChaosPlan(poison={0: 0}, poison_leaf="obj"),
                                  n_lanes=1, segment_len=4)
    sup.submit(probs["a"], generations=8, seed=0)
    with pytest.raises(LaneValidationError, match="finite_objectives"):
        sup.drain()


def test_patience_retires_early_bit_identical():
    """The reference's easy problem (3, 3, 2) with a 640-generation budget
    and ``patience=2`` over segments of 8: the lane retires converged, its
    state the trainer's at ``generations_run``; with patience off it runs
    its whole budget."""
    cfg = GAConfig(pop_size=16, generations=640)
    easy = engine.Problem.from_data(*DATA["easy"], cfg, **CPU)
    sup = Supervisor.for_problems([easy], FaultPolicy(patience=2), n_lanes=1, segment_len=8)
    sup.submit(easy, generations=640, seed=11)
    (r,) = sup.drain()
    assert r.ok and r.converged and r.generations_run < 640
    assert sup.stats["converged"] == 1
    assert_matches_trainer(r, "easy", 11, cfg)
    sup = Supervisor.for_problems([easy], n_lanes=1, segment_len=8)
    sup.submit(easy, generations=16, seed=11)
    (r,) = sup.drain()
    assert not r.converged and r.generations_run == 16
    assert_matches_trainer(r, "easy", 11, cfg)


class TestBackendFallback:
    def test_off_by_default(self):
        """The default policy keeps the jobs' backends: a "kernel" request
        stays "kernel" on this host, where no kernel can launch, and raises
        on CPU tensors at its first dispatch instead of degrading."""
        assert FaultPolicy().backend_fallback is False
        probs, _ = _problems(backends=BackendPolicy(generation="kernel"))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sup = Supervisor.for_problems([probs["a"]], n_lanes=1)
        assert sup.server._cfg.backends == probs["a"].cfg.backends
        assert sup.server._cfg.backends.generation == "kernel"
        sup.submit(probs["a"], generations=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            sup.step()

    def test_explicit_fallback_is_refused(self):
        """``backend_fallback=True`` (the reference's default) is refused
        by name: the port never swaps a kernel for its plain version."""
        with pytest.raises(ValueError, match="never degrades a kernel"):
            FaultPolicy(backend_fallback=True)
        with pytest.raises(ValueError, match="resolve_backends"):
            FaultPolicy(checkpoint_every=2, backend_fallback=True)


# -- against the reference, in ONE subprocess ------------------------------------------

def _load_results(npz, tag) -> dict:
    """The reference's JobResult leaves of one run, by job name."""
    out = {}
    for k in npz.files:
        t, name, field = k.split("/", 2)
        if t == tag:
            out.setdefault(name, {})[field] = npz[k]
    return out


def _leaves(results: dict) -> dict:
    """Port JobResults (by name) in the reference subprocess's form."""
    out = {}
    for name, r in results.items():
        w = dict(state_to_numpy(r.state))
        w = {f: w[f] for f in STATE_FIELDS}
        if r.front is not None:
            w.update((f"front.{f}", np.asarray(r.front[f])) for f in FRONT_FIELDS)
        w.update((f, np.asarray(getattr(r, f))) for f in RESULT_FIELDS + ("job_id",))
        w["error"] = np.asarray(str(r.error))
        out[name] = w
    return out


def assert_same_leaves(want: dict, got: dict, msg, skip=()):
    """Every field of every job, bit for bit (``skip``: fields left out)."""
    assert sorted(want) == sorted(got), msg
    for name in want:
        assert sorted(want[name]) == sorted(got[name]), f"{msg} {name}"
        for f in want[name]:
            if f not in skip:
                assert_bits_equal(want[name][f], got[name][f], f"{msg} {name} {f}")


def assert_same_manifests(want: dict, got: dict, msg):
    assert sorted(want) == sorted(got), msg
    for step in want:
        assert want[step]["step"] == got[step]["step"] == int(step)
        assert want[step]["leaves"] == got[step]["leaves"], f"{msg} step {step}"


def test_supervisor_matches_reference(tmp_path):
    """The port's checkpoint of a mid-flight stream equals the reference's
    leaf for leaf (names, shapes, dtypes, crc32, file crc32, file size; the
    meta blob byte for byte); each package restores the other's and drains
    to the reference's uninterrupted results; the chaos schedule and a
    ``patience`` stream give the reference's results, stats,
    ``recovered_step``, ``dropped_pending`` and manifests."""
    probs, cfg = _problems()
    port_ckpt = tmp_path / "port_ckpt"
    srv = SearchServer.for_problems([probs["a"], probs["b"]], policy="longest", **LANES)
    _submit(srv, probs, CKPT_JOBS)
    srv.step()
    srv.save(str(port_ckpt), allow_pending=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (PROBLEMS, CKPT_JOBS, CHAOS_JOBS, CHAOS, PATIENCE_JOBS,
                                    LANES)]
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp_path),
                             str(port_ckpt), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        # the port's side while the reference compiles and runs
        uninterrupted = {r.name: r for r in srv.drain()}
        chaos, _, sup2, recovered, at_kill = _chaos_run(tmp_path / "port_chaos", probs, cfg)
        chaos_end = _manifests(tmp_path / "port_chaos")
        patience, psup = _patience_run(probs)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    want = np.load(tmp_path / "results.npz")
    with open(tmp_path / "meta.json") as f:
        meta = json.load(f)

    # the checkpoint files, leaf for leaf, and the meta blob
    assert_same_manifests(meta["ckpt_manifests"], _manifests(port_ckpt), "mid-flight")
    blob = lambda d: json.loads(bytes(manager.read_leaf(str(d), 1, "2")))  # noqa: E731
    assert blob(tmp_path / "ref_ckpt") == blob(port_ckpt)
    assert len(meta["ckpt_manifests"]["1"]["leaves"]) == 29
    # the uninterrupted stream, and each package's drain of the other's
    # checkpoint (the queued job resubmitted takes a new id)
    ref_uninterrupted = _load_results(want, "uninterrupted")
    assert_same_leaves(ref_uninterrupted, _leaves(uninterrupted), "uninterrupted")
    assert_same_leaves(ref_uninterrupted, _load_results(want, "from_port"),
                       "the reference's drain of the port's checkpoint", skip=("job_id",))
    assert [p["name"] for p in meta["from_port_pending"]] == ["a-4"]
    rest = SearchServer.restore(str(tmp_path / "ref_ckpt"), srv.spec, cfg, **CPU)
    assert rest.dropped_pending == meta["from_port_pending"]
    _resubmit(rest, probs, CKPT_JOBS)
    assert_same_leaves(ref_uninterrupted, _leaves({r.name: r for r in rest.drain()}),
                       "the port's drain of the reference's checkpoint", skip=("job_id",))
    # the chaos schedule and its recovery
    assert_same_leaves(_load_results(want, "chaos"), _leaves(chaos), "chaos")
    assert [meta["recovered_step"], meta["dropped_pending"]] == list(recovered)
    assert meta["chaos_stats"] == sup2.stats
    assert meta["chaos_killed_stats"] == {"segments": 5, "retries": 1, "checkpoints": 2,
                                          "quarantined": 1, "converged": 0}
    assert_same_manifests(meta["chaos_kill_manifests"], at_kill, "chaos at the kill")
    assert_same_manifests(meta["chaos_end_manifests"], chaos_end, "chaos at the end")
    # patience
    assert_same_leaves(_load_results(want, "patience"), _leaves(patience), "patience")
    assert meta["patience_stats"] == psup.stats
    assert psup.stats["converged"] == 1 and patience["a-32"].generations_run == 20
