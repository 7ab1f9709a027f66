"""The port stands alone and never carries on quietly on the CPU:

* no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro``;
* entry points default to the card and raise without one unless the CPU
  is asked for; a "kernel" backend on a CPU tensor raises;
* config fields whose path is not ported raise ``NotImplementedError``,
  and the backend names are the reference's minus "interpret".
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine
from repro_torch.kernels.backend import BackendPolicy, resolve_backends, BACKEND_CHOICES

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_the_card_unless_asked_for_the_cpu(bc_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = bc_dataset
    with pytest.raises(RuntimeError, match="CUDA"):
        GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train, GAConfig(pop_size=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train)
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                   GAConfig(pop_size=8), device="cpu")
    assert tr.x_int.device.type == "cpu"


@pytest.mark.parametrize("path", ["fitness", "variation", "generation"])
def test_kernel_backend_on_cpu_tensors_raises(bc_dataset, path):
    ds = bc_dataset
    cfg = GAConfig(pop_size=8, generations=1, backends=BackendPolicy(**{path: "kernel"}))
    tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.run()


@pytest.mark.parametrize("which", ["pop_mlp", "pop_variation", "pop_generation"])
def test_kernel_launches_refuse_cpu_tensors(which):
    """Only a wrapper maps a CPU tensor to its plain version; the prepared
    launch under it takes CUDA tensors or raises."""
    from repro_torch.kernels.pop_generation.kernel import pop_generation_call
    from repro_torch.kernels.pop_mlp.kernel import pop_mlp_correct_call
    from repro_torch.kernels.pop_variation.kernel import pop_variation_call

    spec = engine.GenomeSpec(MLPTopology((4, 3, 2)))
    t = spec.table("cpu")
    P, G = 4, spec.n_genes
    pop = torch.zeros((P, G), dtype=torch.int32)
    x, y = torch.zeros((5, 4), dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    var = (pop, pop, torch.ones(P, dtype=torch.int32), t.low, t.high, t.is_mask,
           t.mask_bits, t.ids, torch.zeros((3, 2), dtype=torch.int64), torch.tensor(0.1))
    call = {"pop_mlp": lambda: pop_mlp_correct_call(pop, x, y, spec=spec),
            "pop_variation": lambda: pop_variation_call(*var),
            "pop_generation": lambda: pop_generation_call(*var, x, y, spec=spec)}[which]
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("kw,item", [(dict(variation_mode="mean"), "A10"),
                                     (dict(generations_budget=5), "A12"),
                                     (dict(batch_axis="runs"), "A11")])
def test_unported_config_paths_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        GAConfig(**kw)


def test_config_keeps_every_reference_field_and_backend_names():
    import dataclasses

    ref = {f.name for f in dataclasses.fields(jeng.GAConfig)}
    assert ref == {f.name for f in dataclasses.fields(GAConfig)}
    for path, names in BACKEND_CHOICES.items():
        assert "interpret" not in names and "auto" in names, path
    with pytest.raises(ValueError, match="interpret"):
        BackendPolicy(fitness="interpret")
    pol = resolve_backends(None, ranking="matrix", fitness=None)
    assert (pol.ranking, pol.fitness) == ("matrix", "auto")
    with pytest.raises(ValueError, match="paths"):
        resolve_backends(None, nope="ref")
    cfg = GAConfig(generation_backend="phases")
    assert cfg.backends.generation == "phases" == cfg.generation_backend
    assert cfg.with_backends(BackendPolicy()).backends.generation == "auto"


def test_jnp_oracle_on_a_padded_problem_raises(bc_dataset):
    ds = bc_dataset
    cfg = GAConfig(backends=BackendPolicy(fitness="jnp"))
    p = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                 cfg, device="cpu")
    p.replace_cfg(seed=3)        # re-validating an unpadded problem is fine
    with pytest.raises(NotImplementedError, match="A11"):
        engine.Problem(p.x_int, p.labels, p.baseline_acc, p.spec, cfg,
                       out_mask=torch.as_tensor(np.array([1, 0], np.int32)))
