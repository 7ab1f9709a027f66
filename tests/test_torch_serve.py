"""The port's continuous-batching search service (``repro_torch.serve``) and
the engine's per-lane budget gate it schedules around, bit for bit
(tolerance 0 on int32 and float32):

* (a) the port's ``LaneScheduler`` makes the reference's decisions: the
  reference's own cases, and against the reference's scheduler a seeded
  random stream of enqueues,
  admissions and frees under every policy (both are plain Python);
* (b) a budgeted lane equals the port's plain ``run_scanned`` of its
  budget in every leaf, EvalCache included, and then passes through
  bitwise with aux ``(min error, min area, 0, 0)``, under every dedup mode
  and both CPU generation backends; each generation hands only the active
  lanes to the generation step, and one with none runs nothing;
* (c) ``validate_state`` equals the reference's (one ``jax.jit``) on a
  healthy state and four poisoned ones, lane by lane and in one pass;
* (d) every job the server retires equals the port's ``GATrainer.run`` of
  the same (problem, seed, generations, doping), which
  tests/test_torch_trainer.py holds against the reference's;
* (e) the server against the reference's ``SearchServer``: ONE subprocess
  runs the reference's server on two streams and writes every
  ``JobResult`` field; the port's server on the CPU must equal them all.
  No reference server or budgeted reference scan runs in this process.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax

from repro.core import GAConfig as JCfg, engine as jeng
from repro.core.genome import MLPTopology as JTopo
from repro.serve import LaneScheduler as JScheduler
from repro_torch.core import GAConfig, GATrainer, GenomeSpec, MLPTopology, engine, prng
from repro_torch.core.interop import state_to_numpy
from repro_torch.data import load_dataset
from repro_torch.kernels import pop_generation
from repro_torch.kernels.backend import BackendPolicy
from repro_torch.serve import LaneScheduler, SearchJob, SearchServer
from test_torch_interop import STATE_FIELDS, assert_bits_equal, jax_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
CACHE_FIELDS = ("cache.rows", "cache.vals", "cache.stamp")

# the streams held against the reference: breast_cancer and redwine, pop 16,
# 2 lanes, segment_len 2; budgets 2 to 6 straddling segment boundaries, one
# job doped
STREAMS = {"dedup_off": dict(dedup=False, policy="fifo", baseline=None),
           "dedup_on": dict(dedup=True, policy="longest", baseline=0.9)}
JOBS = [dict(dataset="breast_cancer", generations=3, seed=0, doped=False, name="bc-3"),
        dict(dataset="redwine", generations=5, seed=1, doped=True, name="rw-5"),
        dict(dataset="breast_cancer", generations=2, seed=2, doped=False, name="bc-2"),
        dict(dataset="redwine", generations=6, seed=0, doped=False, name="rw-6")]
RESULT_FIELDS = ("generations", "unique_evals", "cache_hits", "admitted_segment",
                 "retired_segment", "generations_run", "ok", "converged")

REFERENCE_STREAMS = """
    import json, sys
    import numpy as np
    from repro.core import GAConfig, engine
    from repro.core.genome import GenomeSpec, MLPTopology
    from repro.data import load_dataset
    from repro.serve import SearchJob, SearchServer

    out, streams, jobs = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
    data = {n: load_dataset(n) for n in ("breast_cancer", "redwine")}
    for name, c in streams.items():
        cfg = GAConfig(pop_size=16, generations=4, dedup=c["dedup"])
        probs = {n: engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train,
                                             ds.y_train, cfg, baseline_acc=c["baseline"])
                 for n, ds in data.items()}
        srv = SearchServer.for_problems(list(probs.values()), n_lanes=2, segment_len=2,
                                        policy=c["policy"])
        for j in jobs:
            spec = GenomeSpec(MLPTopology(data[j["dataset"]].topology))
            dope = (np.stack([np.asarray(spec.high) - 1, np.asarray(spec.low)])
                    .astype(np.int32) if j["doped"] else None)
            srv.submit(SearchJob(probs[j["dataset"]], j["generations"], seed=j["seed"],
                                 doping_seeds=dope, name=j["name"]))
        leaves = {}
        for r in srv.drain():
            p = f"{r.job_id}/"
            for f in ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen"):
                leaves[p + f] = np.asarray(getattr(r.state, f))
            for f in ("objectives", "indices", "genomes"):
                leaves[p + "front." + f] = np.asarray(r.front[f])
            for f in ("generations", "unique_evals", "cache_hits", "admitted_segment",
                      "retired_segment", "generations_run", "ok", "converged"):
                leaves[p + f] = np.asarray(getattr(r, f))
            leaves[p + "name"] = np.asarray(r.name)
            leaves[p + "error"] = np.asarray(str(r.error))
        np.savez(f"{out}/{name}.npz", **leaves)
"""


@pytest.fixture(scope="module")
def two_datasets():
    # different topologies and sample counts (489 vs 1120): jobs land in
    # different sample-size regimes of the shared padded layout
    return load_dataset("breast_cancer"), load_dataset("redwine")


def _problem(ds, cfg, baseline_acc=None):
    return engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg,
                                    baseline_acc=baseline_acc, **CPU)


def _dope(ds) -> np.ndarray:
    """Two doping genomes: every gene at its upper bound, and at its lower."""
    spec = GenomeSpec(MLPTopology(ds.topology))
    return np.stack([np.asarray(spec.high) - 1, np.asarray(spec.low)]).astype(np.int32)


def _trainer(ds, cfg, seed, generations, baseline_acc=None, doping_seeds=None):
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                   dataclasses.replace(cfg, seed=seed, generations=generations),
                   baseline_acc=baseline_acc, doping_seeds=doping_seeds, **CPU)
    state, _ = tr.run()
    return tr, state


def assert_leaves_equal(a, b, msg="", cache=False):
    """Two port GAStates, every field (and the EvalCache) bit for bit."""
    a, b = state_to_numpy(a), state_to_numpy(b)
    for name in STATE_FIELDS + (CACHE_FIELDS if cache else ()):
        assert_bits_equal(b[name], a[name], f"{msg}: GAState.{name}")


def assert_matches_trainer(r, ds, cfg, seed, baseline=None, dope=None, msg=""):
    tr, state = _trainer(ds, cfg, seed, r.generations, baseline, dope)
    assert_leaves_equal(r.state, state, msg)
    assert r.state.cache is None
    assert (r.unique_evals, r.cache_hits) == (tr.unique_evals, tr.cache_hits), msg
    want = tr.front(state)
    for k in ("objectives", "indices", "genomes"):
        assert_bits_equal(want[k], r.front[k], f"{msg}: front {k}")
    assert r.ok and r.error is None and r.generations_run == r.generations


# -- (a) the scheduler ----------------------------------------------------------

class TestLaneScheduler:
    """The reference's cases (tests/test_serve.py) on the port's scheduler."""

    def test_fifo_order(self):
        s = LaneScheduler(2, "fifo")
        for j in (10, 11, 12):
            s.enqueue(j)
        assert s.admissions({10: 4, 11: 64, 12: 16}) == [(0, 10), (1, 11)]
        assert s.pending == [12]

    def test_longest_first_with_fifo_ties(self):
        s = LaneScheduler(3, "longest")
        for j in (0, 1, 2, 3):
            s.enqueue(j)
        assert s.admissions({0: 16, 1: 64, 2: 16, 3: 32}) == [(0, 1), (1, 3), (2, 0)]
        assert s.pending == [2]

    def test_shortest_first(self):
        s = LaneScheduler(1, "shortest")
        for j in (0, 1):
            s.enqueue(j)
        assert s.admissions({0: 8, 1: 2}) == [(0, 1)]

    def test_freed_lane_backfills(self):
        s = LaneScheduler(1)
        s.enqueue(0)
        s.enqueue(1)
        assert s.admissions({0: 1, 1: 1}) == [(0, 0)]
        assert s.admissions({1: 1}) == []
        s.free(0)
        assert s.admissions({1: 1}) == [(0, 1)]
        assert s.has_work
        s.free(0)
        assert not s.has_work

    def test_double_occupy_raises(self):
        s = LaneScheduler(1)
        s.occupy(0, 7)
        with pytest.raises(ValueError, match="already runs"):
            s.occupy(0, 8)

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="policy"):
            LaneScheduler(2, "random")


@pytest.mark.parametrize("policy", LaneScheduler.POLICIES)
def test_scheduler_random_stream_matches_reference(policy):
    """400 seeded random operations (enqueue, admissions, free) on 3 lanes:
    the port's scheduler returns the reference's decisions and holds its
    state after every one."""
    rng = np.random.default_rng(len(policy))
    port, ref = LaneScheduler(3, policy), JScheduler(3, policy)
    budgets, next_id = {}, 0
    for _ in range(400):
        op = rng.integers(3)
        if op == 0:
            budgets[next_id] = int(rng.integers(1, 6))   # ties exercise the FIFO order
            port.enqueue(next_id)
            ref.enqueue(next_id)
            next_id += 1
        elif op == 1:
            want = {j: budgets[j] for j in ref.pending}
            assert port.admissions(dict(want)) == ref.admissions(want)
        elif ref.busy_lanes:
            lane = int(rng.choice(ref.busy_lanes))
            port.free(lane)
            ref.free(lane)
        assert (port.lane_job, port.pending, port.busy_lanes, port.has_work) == (
            ref.lane_job, ref.pending, ref.busy_lanes, ref.has_work)
    assert next_id > 100


# -- (b) the budget gate ----------------------------------------------------------

GATE_CASES = {
    **{f"{backend}-dedup_{dedup}": dict(dedup=dedup, backends=BackendPolicy(generation=backend))
       for dedup in (False, "legacy", True) for backend in ("ref", "phases")},
    "ref-mean": dict(variation_mode="mean", n_device_samples=3,
                     backends=BackendPolicy(generation="ref")),
}


def _padded_lanes(two_datasets, cfg):
    """breast_cancer and redwine padded into their shared layout, single
    and untagged (their plain runs)."""
    from repro_torch.core import sweep

    probs = [_problem(ds, cfg) for ds in two_datasets]
    spec = sweep.suite_spec(probs)
    s_max = max(p.x_int.shape[0] for p in probs)
    return [engine.pad_problem(p, spec, s_max) for p in probs]


def _gated(lanes, budgets):
    """The lanes stacked with the budget gate on and per-lane budgets."""
    return engine.stack_problems([
        dataclasses.replace(p.replace_cfg(generations_budget=0),
                            generations_budget=torch.tensor(b, dtype=torch.int32))
        for p, b in zip(lanes, budgets)])


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_budgeted_lanes_equal_plain_runs_then_pass_through(two_datasets, case):
    """Lanes with budgets 2 and 4 run in one batched problem for 3 + 3
    generations (two calls, so the gate resumes across calls): each lane
    equals the plain ``run_scanned`` of its budget in every leaf, cache
    included; each generation past the budget reports ``(min error, min
    area, 0, 0)``; a later call leaves the exhausted lanes bitwise as
    they were."""
    cfg = GAConfig(pop_size=16, **GATE_CASES[case])
    lanes, budgets, seeds = _padded_lanes(two_datasets, cfg), (2, 4), (3, 5)
    gated = _gated(lanes, budgets)
    keys = torch.stack([prng.PRNGKey(s, "cpu") for s in seeds])
    states, _ = engine.init_state(gated, keys)
    states, aux1 = engine.run_scanned(gated, states, 3)
    states, aux2 = engine.run_scanned(gated, states, 3)
    aux = tuple(torch.cat([a, b], dim=1) for a, b in zip(aux1, aux2))
    for i, (p, b, seed) in enumerate(zip(lanes, budgets, seeds)):
        plain, _ = engine.init_state(p, prng.PRNGKey(seed, "cpu"))
        plain, plain_aux = engine.run_scanned(p, plain, b)
        got = engine.state_at(states, i)
        assert_leaves_equal(got, plain, f"{case} lane {i} budget {b}",
                            cache=plain.cache is not None)
        for k in range(4):
            assert_bits_equal(plain_aux[k], aux[k][i, :b], f"{case} lane {i} aux[{k}]")
        tail = (plain.obj[:, 0].min(), plain.obj[:, 1].min(), 0, 0)
        for k in range(4):
            assert_bits_equal(torch.as_tensor(tail[k]).expand(6 - b).to(aux[k].dtype),
                              aux[k][i, b:], f"{case} lane {i} passthrough aux[{k}]")
    again, aux3 = engine.run_scanned(gated, states, 2)
    for i in range(2):
        assert_leaves_equal(engine.state_at(again, i), engine.state_at(states, i),
                            f"{case} exhausted lane {i}", cache=states.cache is not None)
    assert int(aux3[2].sum()) == int(aux3[3].sum()) == 0


def test_generations_get_only_the_active_lanes(two_datasets, monkeypatch):
    """A counted generation step: three lanes with budgets 1, 3 and 0 run
    for 5 generations; each generation receives exactly the lanes with
    budget left (its problem holds those lanes only, so every launch
    covers them alone), and generations with none run nothing."""
    cfg = GAConfig(pop_size=16)
    bc, rw = _padded_lanes(two_datasets, cfg)
    gated = _gated([bc, rw, bc], (1, 3, 0))
    keys = torch.stack([prng.PRNGKey(s, "cpu") for s in (0, 1, 2)])
    states, _ = engine.init_state(gated, keys)
    assert engine.lane_active(gated, states).tolist() == [True, True, False]
    lanes = gated.lanes()
    calls, step = [], pop_generation.generation_lanes

    def counted(problem, sub_lanes, sub_states, **kw):
        ids = tuple(next(i for i, p in enumerate(lanes) if p is q) for q in sub_lanes)
        calls.append(ids)
        assert problem.n_lanes == len(ids) == len(sub_states)
        assert engine.lane_data(problem).x.shape[0] == len(ids)
        for j, i in enumerate(ids):
            assert torch.equal(problem.x_int[j], gated.x_int[i])
        return step(problem, sub_lanes, sub_states, **kw)

    monkeypatch.setattr(pop_generation, "generation_lanes", counted)
    out, aux = engine.run_scanned(gated, states, 5)
    assert calls == [(0, 1), (1,), (1,)]
    assert aux[2].shape == (3, 5) and int(aux[2][:, 3:].sum()) == 0
    assert [int(g) for g in out.gen] == [1, 3, 0]
    assert not engine.lane_active(gated, out).any()
    calls.clear()
    engine.run_scanned(gated, out, 4)
    assert calls == []


# -- (c) validate_state -------------------------------------------------------------

def _poisoned(leaves: dict, what: str, n_valid: int, high) -> dict:
    out = {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in leaves.items()}
    if what == "nan_objective":
        out["obj"][3, 0] = np.nan
    elif what == "gene_out_of_bounds":
        out["pop"][5, 2] = high[2]
    elif what == "count_above_samples":
        out["counts"][7] = n_valid + 1
    elif what == "stamp_beyond_gen":
        live = np.flatnonzero(out["cache.stamp"] >= 0)
        out["cache.stamp"][live[0]] = int(out["gen"]) + 1
    return out


POISONS = {"healthy": None, "nan_objective": 0, "gene_out_of_bounds": 1,
           "count_above_samples": 2, "stamp_beyond_gen": 3}


def test_validate_state_matches_reference(bc_dataset):
    """The port's checks equal the reference's ``validate_state`` (one
    ``jax.jit``, one compile for all five states) on a healthy
    breast_cancer state after 2 generations and four poisoned copies, each
    of which trips its own check alone; the lane-batched form gives the
    same (5, 4) flags in one pass."""
    from repro_torch.core.interop import state_from_numpy

    ds = bc_dataset
    cfg = GAConfig(pop_size=16)
    p = _problem(ds, cfg)
    st, _ = engine.init_state(p, prng.PRNGKey(4, "cpu"))
    st, _ = engine.run_scanned(p, st, 2)
    base = state_to_numpy(st)
    jprob = jeng.Problem.from_data(JTopo(ds.topology), ds.x_train, ds.y_train,
                                   JCfg(pop_size=16))
    check = jax.jit(jeng.validate_state)
    high, n_valid = p.genes.high.numpy(), int(p.n_valid_samples)
    ports, singles = [], []
    for what, bad in POISONS.items():
        leaves = _poisoned(base, what, n_valid, high)
        want = np.asarray(check(jprob, jax_state(leaves)))
        port = state_from_numpy(leaves)
        got = engine.validate_state(p, port)
        assert got.dtype == torch.bool and got.shape == (len(engine.VALIDATION_CHECKS),)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        np.testing.assert_array_equal(want, [i != bad for i in range(4)], err_msg=what)
        assert bool(engine.validate_ok(p, port)) == (bad is None)
        ports.append(port)
        singles.append(got)
    stacked = engine.stack_problems([p] * len(ports))
    batched = engine.validate_state(stacked, engine.stack_states(ports))
    assert torch.equal(batched, torch.stack(singles))
    assert engine.validate_ok(stacked, engine.stack_states(ports)).tolist() == [
        bad is None for bad in POISONS.values()]


def test_validate_state_device_variation_and_no_cache(bc_dataset):
    """(C, K) cache values under device variation and a state without a
    cache: a healthy lane passes, a live value above the sample count
    trips ``cache_accounting`` alone."""
    ds = bc_dataset
    for cfg in (GAConfig(pop_size=16, variation_mode="mean", n_device_samples=3),
                GAConfig(pop_size=16, dedup=False)):
        p = _problem(ds, cfg)
        st, _ = engine.init_state(p, prng.PRNGKey(1, "cpu"))
        assert engine.validate_state(p, st).all()
        if st.cache is None:
            continue
        assert st.cache.vals.dim() == 2
        live = int(torch.nonzero(st.cache.stamp >= 0)[0])
        st.cache.vals[live, 2] = int(p.n_valid_samples) + 1
        assert engine.validate_state(p, st).tolist() == [True, True, True, False]


# -- (d) the server against the port's GATrainer.run ----------------------------------

def _port_stream(two_datasets, c):
    """The port's server on one of :data:`STREAMS` → (results by job id,
    the config)."""
    cfg = GAConfig(pop_size=16, generations=4, dedup=c["dedup"])
    data = {ds.name: ds for ds in two_datasets}
    probs = {n: _problem(ds, cfg, c["baseline"]) for n, ds in data.items()}
    srv = SearchServer.for_problems(list(probs.values()), n_lanes=2, segment_len=2,
                                    policy=c["policy"])
    assert srv.device.type == "cpu"
    for j in JOBS:
        srv.submit(SearchJob(probs[j["dataset"]], j["generations"], seed=j["seed"],
                             doping_seeds=_dope(data[j["dataset"]]) if j["doped"] else None,
                             name=j["name"]))
    results = {r.job_id: r for r in srv.drain()}
    assert sorted(results) == list(range(len(JOBS))) and not srv.has_work
    return results, cfg


@pytest.fixture(scope="module")
def port_streams(two_datasets):
    return {name: _port_stream(two_datasets, c) for name, c in STREAMS.items()}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_server_matches_sequential_trainers(two_datasets, port_streams, stream):
    """A heterogeneous stream (both datasets, budgets straddling segment
    boundaries, one doped job, a bounded baseline under dedup) retires
    every job equal to its standalone trainer, accounting included."""
    results, cfg = port_streams[stream]
    data = {ds.name: ds for ds in two_datasets}
    base = STREAMS[stream]["baseline"]
    for jid, j in enumerate(JOBS):
        ds = data[j["dataset"]]
        r = results[jid]
        assert (r.name, r.generations) == (j["name"], j["generations"])
        assert_matches_trainer(r, ds, cfg, j["seed"], base, _dope(ds) if j["doped"] else None,
                               f"{stream} job {jid}")


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("dataset_idx", [0, 1])
def test_mid_stream_admission_matches_cold_start(two_datasets, dedup, dataset_idx):
    """A job admitted at segment 1 (lanes hot, the other dataset beside it)
    equals the same job run alone, from either sample-size regime."""
    cfg = GAConfig(pop_size=16, generations=4, dedup=dedup)
    problems = [_problem(ds, cfg) for ds in two_datasets]
    srv = SearchServer.for_problems(problems, n_lanes=2, segment_len=2)
    srv.submit(problems[1 - dataset_idx], generations=6, seed=0)
    srv.submit(problems[1 - dataset_idx], generations=4, seed=1)
    results = srv.step()
    assert srv.segments_done == 1
    probe = srv.submit(problems[dataset_idx], generations=3, seed=7)
    results.extend(srv.drain())
    got = {r.job_id: r for r in results}[probe]
    assert got.admitted_segment >= 1, "probe job was not admitted late"
    assert_matches_trainer(got, two_datasets[dataset_idx], cfg, 7, msg="mid-stream")


def test_retired_lanes_leave_survivors_clean(two_datasets):
    """A short job retires while a long one runs on: the survivor keeps
    finite objectives and equals its trainer, and the retired lane's
    parked slot takes no launch."""
    bc, rw = two_datasets
    cfg = GAConfig(pop_size=16, generations=6)
    pa, pb = _problem(bc, cfg), _problem(rw, cfg)
    srv = SearchServer.for_problems([pa, pb], n_lanes=2, segment_len=2)
    short = srv.submit(pa, generations=2, seed=0)
    long_ = srv.submit(pb, generations=6, seed=1)
    results, seen_after_retire = {}, False
    while srv.has_work:
        for r in srv.step():
            results[r.job_id] = r
        if short in results and srv.has_work:
            seen_after_retire = True
            assert srv.active_jobs == {1: long_}
            assert int(srv.lane_problem(0).generations_budget) == 0
    assert seen_after_retire, "the short job should retire before the long one"
    survivor = results[long_].state
    assert torch.isfinite(survivor.obj).all() and not torch.isnan(survivor.crowd).any()
    assert_matches_trainer(results[long_], rw, cfg, 1, msg="survivor lane")
    assert_matches_trainer(results[short], bc, cfg, 0, msg="short lane")


def test_submit_validation(two_datasets, monkeypatch):
    bc, rw = two_datasets
    cfg = GAConfig(pop_size=16, generations=4)
    pa = _problem(bc, cfg)
    srv = SearchServer.for_problems([pa], n_lanes=2)
    with pytest.raises(ValueError, match="GAConfig does not match"):
        srv.submit(_problem(bc, dataclasses.replace(cfg, pop_size=32)), generations=4)
    with pytest.raises(ValueError, match="samples"):
        srv.submit(_problem(rw, cfg), generations=4)   # 1120 > 489
    with pytest.raises(ValueError, match="generations"):
        srv.submit(pa, generations=0)
    with pytest.raises(ValueError, match="jnp"):
        SearchServer(pa.spec, GAConfig(backends=BackendPolicy(fitness="jnp")),
                     max_samples=10, **CPU)
    with pytest.raises(ValueError, match="segment_len"):
        SearchServer(pa.spec, cfg, max_samples=10, segment_len=0, **CPU)
    # a job whose config differs only in what the server owns is accepted
    srv.submit(pa.replace_cfg(generations_budget=9, batch_axis=engine.BATCH_AXIS),
               generations=4)
    for call in (lambda: srv.save("unused"),
                 lambda: SearchServer.restore("unused", pa.spec, cfg)):
        with pytest.raises(NotImplementedError, match="A12b"):
            call()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchServer(pa.spec, cfg, max_samples=10)


def test_retire_and_quarantine_lanes(two_datasets):
    """``retire_lane`` after one segment returns a healthy result that ran
    2 generations (equal to a 2-generation trainer); a NaN written into the
    other lane's objectives flags ``finite_objectives`` on that lane only,
    and ``quarantine_lane`` returns it failed and frees the slot, which the
    next job takes cleanly."""
    bc, rw = two_datasets
    cfg = GAConfig(pop_size=16, generations=6)
    pa, pb = _problem(bc, cfg), _problem(rw, cfg)
    srv = SearchServer.for_problems([pa, pb], n_lanes=2, segment_len=2)
    a = srv.submit(pa, generations=6, seed=2)
    b = srv.submit(pb, generations=6, seed=3)
    assert srv.step() == []
    for lane in (0, 1):
        assert engine.validate_state(srv.lane_problem(lane), srv.lane_state(lane)).all()
    srv.lane_state(1).obj[0, 0] = float("nan")
    flags = [engine.validate_state(srv.lane_problem(lane), srv.lane_state(lane)).tolist()
             for lane in (0, 1)]
    assert flags == [[True] * 4, [False, True, True, True]]
    bad = srv.quarantine_lane(1, "finite_objectives")
    assert (bad.job_id, bad.ok, bad.front, bad.error, bad.generations_run) == (
        b, False, None, "finite_objectives", 2)
    assert torch.isnan(bad.state.obj[0, 0])
    done = srv.retire_lane(0, converged=True)
    assert (done.job_id, done.converged, done.generations_run) == (a, True, 2)
    tr, state = _trainer(bc, cfg, 2, 2)
    assert_leaves_equal(done.state, state, "retired lane")
    assert (done.unique_evals, done.cache_hits) == (tr.unique_evals, tr.cache_hits)
    assert not srv.has_work and srv.active_jobs == {}
    for call in (lambda: srv.retire_lane(0), lambda: srv.quarantine_lane(1, "x")):
        with pytest.raises(ValueError, match="no job"):
            call()
    c = srv.submit(pb, generations=3, seed=3)
    (r,) = srv.drain()
    assert r.job_id == c
    assert_matches_trainer(r, rw, cfg, 3, msg="after quarantine")


# -- (e) the server against the reference's SearchServer ------------------------------

def _reference_streams(out) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_STREAMS), str(out),
                          json.dumps(STREAMS), json.dumps(JOBS)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]


def test_server_matches_reference_search_server(two_datasets, port_streams, tmp_path):
    """Both streams, every ``JobResult`` field: the state leaves, the front,
    ``unique_evals``, ``cache_hits``, the segments, ``generations_run``,
    ``ok``, ``converged``, the name and the error."""
    _reference_streams(tmp_path)
    for stream in STREAMS:
        want = np.load(tmp_path / f"{stream}.npz")
        results, _ = port_streams[stream]
        for jid, r in results.items():
            p = f"{jid}/"
            got = state_to_numpy(r.state)
            for f in STATE_FIELDS:
                assert_bits_equal(want[p + f], got[f], f"{stream} job {jid} {f}")
            for f in ("objectives", "indices", "genomes"):
                assert_bits_equal(want[p + "front." + f], r.front[f],
                                  f"{stream} job {jid} front {f}")
            for f in RESULT_FIELDS:
                assert want[p + f] == getattr(r, f), f"{stream} job {jid} {f}"
            assert str(want[p + "name"]) == r.name and str(want[p + "error"]) == str(r.error)
        assert len(results) == len({k.split("/")[0] for k in want.files})
