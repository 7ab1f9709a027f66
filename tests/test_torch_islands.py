"""The port's island-parallel NSGA-II (``core.islands``: islands as lanes of
one batched run on a ``DeviceMesh``) and the one-device mesh of
``run_grid``/``run_suite``, bit for bit (tolerance 0 on int32 and float32):

* 1-island runs equal the port's ``GATrainer.run`` (``tests/test_engine.py``,
  ``tests/test_generation_path.py``), ranking backends agree
  (``tests/test_ranking_path.py``);
* the ring against the reference's ``shard_map`` islands: ONE subprocess
  with 4 placeholder CPU devices runs the reference's ``build_island_step``
  round by round and writes every carry leaf after init and after each
  round; the port's rounds on a ``DeviceMesh`` of the same shape must equal
  every leaf at every round (the reference never runs in this process);
* mesh-sharded ``run_grid``/``run_suite`` equal their unsharded runs, and
  meshes over distinct devices raise (ROADMAP A13b).
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

from repro_torch.core import (GAConfig, GATrainer, GenomeSpec, IslandConfig, MLPTopology,
                              build_island_step, engine, islands, run_islands, sweep)
from repro_torch.core.quantize import quantize_inputs
from repro_torch.data import load_dataset
from repro_torch.kernels.backend import BackendPolicy
from repro_torch.launch import DeviceMesh, make_host_mesh, make_mesh
from test_torch_interop import assert_bits_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRY = ("pop", "obj", "viol", "counts", "rank", "crowd", "key",
         "cache.rows", "cache.vals", "cache.stamp")
CPU = dict(device="cpu")

# the rings held against the reference: breast_cancer, island_pop 16,
# migrate_every 3, n_migrants 2, 3 rounds
RING = dict(island_pop=16, migrate_every=3, n_migrants=2, rounds=3)
RINGS = {
    "data4_dedup_off": dict(mesh=[4], axes=["data"], ga=dict(dedup=False), seed=3,
                            baseline=1.0, dope=False),
    "data4_dedup_on": dict(mesh=[4], axes=["data"], ga=dict(dedup=True), seed=3,
                           baseline=1.0, dope=False),
    "data4_mean": dict(mesh=[4], axes=["data"],
                       ga=dict(variation_mode="mean", n_device_samples=3), seed=5,
                       baseline=0.9, dope=False),
    "pod2_data2": dict(mesh=[2, 2], axes=["pod", "data"], ga=dict(), seed=7,
                       baseline=0.9, dope=True),
}

REFERENCE_RINGS = """
    import json, sys
    import warnings
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.engine import GAConfig
    from repro.core.genome import GenomeSpec, MLPTopology
    from repro.core.islands import IslandConfig, build_island_step
    from repro.core.quantize import quantize_inputs
    from repro.data import load_dataset

    out, rings, ring, dope = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3]), sys.argv[4]
    warnings.simplefilter("ignore")   # the unusable donated init buffers
    names = ("pop", "obj", "viol", "counts", "rank", "crowd", "key",
             "cache.rows", "cache.vals", "cache.stamp")
    ds = load_dataset("breast_cancer")
    topo = MLPTopology(ds.topology)
    x_int = quantize_inputs(jnp.asarray(ds.x_train, jnp.float32), topo.input_bits)
    for name, c in rings.items():
        mesh = jax.make_mesh(tuple(c["mesh"]), tuple(c["axes"]))
        cfg = IslandConfig(ga=GAConfig(**c["ga"]), **ring)
        init, round_fn = build_island_step(GenomeSpec(topo), cfg, mesh, x_int, ds.y_train,
                                           c["baseline"], tuple(c["axes"]))
        carry = init(c["seed"], np.load(dope) if c["dope"] else None)
        # laid out as the rounds lay out their outputs, so the first round's
        # compile serves every round (placement only: the values are init's)
        carry = jax.device_put(carry, NamedSharding(mesh, P(tuple(c["axes"]))))
        leaves = {}
        for r in range(cfg.rounds + 1):
            if r:
                carry = round_fn(*carry)     # donates the carry: save it first
            leaves.update({f"{r}/{k}": np.asarray(v) for k, v in zip(names, carry)})
        np.savez(f"{out}/{name}.npz", **leaves)
"""


def _dope(ds) -> np.ndarray:
    """Two doping genomes of breast_cancer: every gene at its upper bound,
    and at its lower bound."""
    spec = GenomeSpec(MLPTopology(ds.topology))
    return np.stack([np.asarray(spec.high) - 1, np.asarray(spec.low)]).astype(np.int32)


def _trainer(ds, cfg, baseline_acc=None):
    """(front, final state) of the port's GATrainer.run on the CPU."""
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg,
                   baseline_acc=baseline_acc, **CPU)
    state = tr.run()[0]
    return tr.front(state), state


def _islands(ds, cfg, mesh=None, axis_names=("data",), **kw):
    mesh = make_mesh((1,), ("data",), **CPU) if mesh is None else mesh
    return run_islands(MLPTopology(ds.topology), ds.x_train, ds.y_train, mesh, cfg,
                       axis_names=axis_names, **kw)[0]


def assert_fronts_equal(a, b, msg=""):
    f64 = lambda f: np.asarray(f["objectives"], np.float64).view(np.int64)   # noqa: E731
    assert_bits_equal(f64(a), f64(b), f"{msg}: front objectives")
    assert_bits_equal(a["genomes"], b["genomes"], f"{msg}: front genomes")


# -- (a) one island is a GATrainer run ------------------------------------------

@pytest.mark.parametrize("baseline_acc", [None, 0.9], ids=["chance", "bounded"])
def test_single_island_matches_trainer(bc_dataset, baseline_acc):
    """Degenerate ring (1 island, migrate_every == generations): the same
    engine steps as GATrainer.run, so the same front, bit for bit; with a
    bounded baseline both peel the infeasible rows first."""
    ds = bc_dataset
    cfg = GAConfig(pop_size=16, generations=6, seed=3 if baseline_acc is None else 1)
    icfg = IslandConfig(ga=cfg, island_pop=16, migrate_every=6, n_migrants=2, rounds=1)
    kw = {} if baseline_acc is None else dict(baseline_acc=baseline_acc)
    f_tr, state = _trainer(ds, cfg, baseline_acc)
    assert_fronts_equal(f_tr, _islands(ds, icfg, seed=cfg.seed, **kw), "islands vs trainer")
    if baseline_acc is not None:
        assert (state.viol > 0).any() and (state.viol <= 0).any(), \
            "the bound must split the rows"


def test_single_island_cache_vs_off_equals_trainer(bc_dataset):
    """The cache leaves ride the carry across rounds (gen restarting at 0):
    dedup off and on give the same front, which is the 6-generation
    trainer's."""
    ds = bc_dataset
    fronts = {}
    for dedup in (False, True):
        cfg = GAConfig(pop_size=16, generations=6, seed=3, dedup=dedup)
        icfg = IslandConfig(ga=cfg, island_pop=16, migrate_every=3, n_migrants=2, rounds=2)
        fronts[dedup] = _islands(ds, icfg, seed=3)
    assert_fronts_equal(fronts[False], fronts[True], "dedup off vs on")
    assert_fronts_equal(_trainer(ds, GAConfig(pop_size=16, generations=6, seed=3))[0],
                        fronts[True], "islands vs trainer")


# -- (b) ranking backends -------------------------------------------------------

@pytest.mark.parametrize("n_islands", [1, 4])
def test_islands_sweep_vs_matrix(bc_dataset, n_islands):
    """The ring's re-rank goes through the ranking dispatcher: the fronts
    are backend-independent (on 4 islands the migration re-ranks too)."""
    ds = bc_dataset
    fronts = {}
    for backend in ("matrix", "sweep"):
        cfg = GAConfig(pop_size=16, generations=6, seed=3,
                       backends=BackendPolicy(ranking=backend))
        icfg = IslandConfig(ga=cfg, island_pop=16, migrate_every=3, n_migrants=2, rounds=2)
        fronts[backend] = _islands(ds, icfg, make_mesh((n_islands,), ("data",), **CPU),
                                   seed=3)
    assert_fronts_equal(fronts["matrix"], fronts["sweep"], "matrix vs sweep")


# -- (c) the ring against the reference's shard_map islands -----------------------

def _reference_rings(out, dope_path) -> None:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_RINGS), str(out),
                          json.dumps(RINGS), json.dumps(RING), str(dope_path)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-4000:]


def _port_rounds(ds, c, dope):
    """The port's carry after init and after every round (numpy)."""
    topo = MLPTopology(ds.topology)
    x_int = quantize_inputs(torch.as_tensor(ds.x_train, dtype=torch.float32), topo.input_bits)
    cfg = IslandConfig(ga=GAConfig(**c["ga"]), **RING)
    mesh = make_mesh(tuple(c["mesh"]), tuple(c["axes"]), **CPU)
    init, round_fn = build_island_step(GenomeSpec(topo), cfg, mesh, x_int, ds.y_train,
                                       c["baseline"], tuple(c["axes"]))
    carry = init(c["seed"], dope if c["dope"] else None)
    out = []
    for r in range(cfg.rounds + 1):
        if r:
            carry = round_fn(*carry)
        out.append(carry)
    return out


def test_rings_match_reference_shard_map_islands(bc_dataset, tmp_path):
    """4 islands on a ("data",) ring (dedup off and on, nominal and
    ``variation_mode="mean"``) and 2 × 2 on ("pod", "data"), doped and
    bounded: every carry leaf after init and after each of 3 rounds equals
    the reference's ``shard_map`` islands (the migration moves rows: a
    round's migrants differ from a ring-free run's)."""
    ds = bc_dataset
    dope = _dope(ds)
    np.save(tmp_path / "dope.npy", dope)
    _reference_rings(tmp_path, tmp_path / "dope.npy")
    for name, c in RINGS.items():
        ref = np.load(tmp_path / f"{name}.npz")
        rounds = _port_rounds(ds, c, dope)
        n_leaves = 10 if c["ga"].get("dedup", True) else 7
        for r, carry in enumerate(rounds):
            assert len(carry) == n_leaves, f"{name}: carry leaves"
            for leaf, t in zip(CARRY, carry):
                assert_bits_equal(ref[f"{r}/{leaf}"], t, f"{name} round {r}: {leaf}")
        n = int(np.prod(c["mesh"]))
        assert rounds[-1][0].shape == (n * RING["island_pop"], GenomeSpec(
            MLPTopology(ds.topology)).n_genes)
        if c["ga"].get("variation_mode") == "mean":
            assert rounds[-1][1].shape[1] == 3 and rounds[-1][3].shape[1] == 3


def test_ring_moves_best_rows_to_the_next_island():
    """The ring on hand-made ranks: island i's two best rows (rank, then
    crowding descending, ties by index) land on island i + 1's two worst;
    on (2, 2) the payload steps along "data" and then along "pod"."""
    n, rows = 4, 5
    rank = torch.tensor([[0, 1, 0, 2, 1]] * n, dtype=torch.int32)
    crowd = torch.tensor([[1.0, float("inf"), float("inf"), 0.0, 0.5]] * n)
    order = islands._ring_order(rank, crowd)
    assert order[0].tolist() == [2, 0, 1, 4, 3]
    tag = torch.arange(n * rows, dtype=torch.int32).reshape(n, rows)
    best, worst = order[:, :2], order[:, -2:]
    for layout, src in (((4,), [3, 0, 1, 2]), ((2, 2), [3, 2, 1, 0])):
        moved = islands._put(tag, worst, islands._send(islands._rows(tag, best), layout))
        for i in range(n):
            assert moved[i, worst[i]].tolist() == (src[i] * rows + best[src[i]]).tolist()
            keep = [j for j in range(rows) if j not in worst[i].tolist()]
            assert moved[i, keep].tolist() == tag[i, keep].tolist()


# -- (d) the mesh of run_grid / run_suite, and its refusals ------------------------

def _problem(ds, **kw):
    return engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                    GAConfig(pop_size=8, generations=2, **kw), **CPU)


def assert_runs_equal(a, b, msg):
    from repro_torch.core.interop import state_to_numpy

    for i in range(a.n_cells):
        la, lb = state_to_numpy(a.state_at(i)), state_to_numpy(b.state_at(i))
        assert set(la) == set(lb), msg
        for k in la:
            assert_bits_equal(la[k], lb[k], f"{msg} cell {i}: {k}")
    for k in range(4):
        assert_bits_equal(a.aux[k], b.aux[k], f"{msg}: aux[{k}]")
    assert_bits_equal(a.init_evals, b.init_evals, f"{msg}: init_evals")


MESHES = {"one": ((1,), ("data",)), "four": ((4,), ("data",)),
          "pod2_data2": ((2, 2), ("pod", "data"))}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_grid_on_a_one_device_mesh_equals_the_unsharded_grid(bc_dataset, mesh):
    shape, axes = MESHES[mesh]
    p = _problem(bc_dataset)
    kw = dict(mutation_rates=(0.02, 0.05, 0.1), doping_seeds=_dope(bc_dataset)[:1])
    plain = sweep.run_grid(p, [0], **kw)
    sharded = sweep.run_grid(p, [0], mesh=make_mesh(shape, axes, **CPU), axis_names=axes,
                             **kw)
    assert sharded.n_cells == plain.n_cells == 3
    assert_runs_equal(plain, sharded, f"grid on {mesh}")


@pytest.mark.parametrize("mesh", ["one", "four"])
def test_suite_on_a_one_device_mesh_equals_the_unsharded_suite(bc_dataset, mesh):
    shape, axes = MESHES[mesh]
    rw = load_dataset("redwine")
    problems = [_problem(bc_dataset), _problem(rw)]
    rw_dope = np.asarray(GenomeSpec(MLPTopology(rw.topology)).low, np.int32)[None]
    kw = dict(doping_seeds=[_dope(bc_dataset), rw_dope], sample_bucket_factor=2.0)
    plain = sweep.run_suite(problems, [0], **kw)
    sharded = sweep.run_suite(problems, [0], mesh=make_mesh(shape, axes, **CPU),
                              axis_names=axes, **kw)
    assert sharded.n_cells == plain.n_cells == 2
    assert_runs_equal(plain, sharded, f"suite on {mesh}")


def test_distinct_devices_and_missing_cards_raise(bc_dataset, monkeypatch):
    ds = bc_dataset
    p = _problem(ds)
    import jax

    for mesh in (jax.make_mesh((1,), ("data",)), object(), make_host_mesh().__dict__):
        with pytest.raises(NotImplementedError, match="A13b"):
            sweep.run_grid(p, [0], mesh=mesh)
        with pytest.raises(NotImplementedError, match="A13b"):
            _islands(ds, IslandConfig(ga=GAConfig(pop_size=8), rounds=0), mesh)
    with pytest.raises(ValueError, match="mesh lives on"):
        sweep.run_grid(p, [0], mesh=make_mesh((1,), ("data",), device="meta"))
    with pytest.raises(ValueError, match="not in the mesh"):
        sweep.run_grid(p, [0], mesh=make_host_mesh(), axis_names=("pod",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1,), ("data",))
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMesh((4,), ("data",), "cuda")
    host = make_host_mesh()
    assert (host.shape, host.device) == ({"data": 1, "model": 1}, torch.device("cpu"))


def test_island_config_keeps_the_reference_fields():
    from repro.core.islands import IslandConfig as JIslandConfig

    ref = {f.name: f.default for f in dataclasses.fields(JIslandConfig) if f.name != "ga"}
    port = {f.name: f.default for f in dataclasses.fields(IslandConfig) if f.name != "ga"}
    assert port == ref == dict(island_pop=64, migrate_every=10, n_migrants=4, rounds=10)
    assert IslandConfig().ga == GAConfig()
