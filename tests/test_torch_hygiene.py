"""The port stands alone and never carries on quietly on the CPU:

* no module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package ``repro``;
* entry points default to the card and raise without one unless the CPU
  is asked for; a "kernel" backend on a CPU tensor raises, and so does
  ``use_kernel=True`` in the LM-side ops;
* every config field of the reference is accepted (the budget gate of
  A12a included) or refused as the reference refuses it, and the backend
  names are the reference's minus "interpret";
  device-variation fitness is ported and needs a count-based backend;
* every C launcher in ``csrc/*.cu`` is bound with the ctypes signature of
  its parameters, so a changed launcher cannot be called with a stale one.
"""
import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro_torch.core import GAConfig, GATrainer, MLPTopology, engine
from repro_torch.kernels import _cuda
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


@pytest.mark.parametrize("which", ["pop_mlp", "pop_variation", "pop_generation",
                                   "pop_mlp_mc", "pop_generation_mc", "ssd_scan",
                                   "pow2_matmul", "flash_attention"])
def test_kernel_launches_refuse_cpu_tensors(which):
    """Only a wrapper maps a CPU tensor to its plain version; the prepared
    launch under it takes CUDA tensors or raises."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_call
    from repro_torch.kernels.pop_generation.kernel import pop_generation_call
    from repro_torch.kernels.pop_mlp.kernel import pop_mlp_correct_call
    from repro_torch.kernels.pop_variation.kernel import pop_variation_call
    from repro_torch.kernels.pow2_matmul.kernel import pow2_matmul_call
    from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan_call

    spec = engine.GenomeSpec(MLPTopology((4, 3, 2)))
    t = spec.table("cpu")
    P, G = 4, spec.n_genes
    pop = torch.zeros((P, G), dtype=torch.int32)
    x, y = torch.zeros((5, 4), dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    var = (pop, pop, torch.ones(P, dtype=torch.int32), t.low, t.high, t.is_mask,
           t.mask_bits, t.ids, torch.zeros((3, 2), dtype=torch.int64), torch.tensor(0.1))
    call = {"pop_mlp": lambda: pop_mlp_correct_call(pop, x, y, spec=spec),
            "pop_variation": lambda: pop_variation_call(*var),
            "pop_generation": lambda: pop_generation_call(*var, x, y, spec=spec),
            "pop_mlp_mc": lambda: pop_mlp_correct_call(pop, x, y, spec=spec, dev=pop[:2],
                                                       gene_high=t.high),
            "pop_generation_mc": lambda: pop_generation_call(*var, x, y, spec=spec,
                                                             dev=pop[:2]),
            "ssd_scan": lambda: ssd_state_scan_call(torch.zeros((1, 2, 4, 4, 4)),
                                                    torch.ones((1, 2, 4))),
            "pow2_matmul": lambda: pow2_matmul_call(torch.zeros((4, 8)),
                                                    torch.zeros((8, 4), dtype=torch.uint8)),
            "flash_attention": lambda: flash_attention_call(*[torch.zeros((2, 16, 8))] * 3),
            }[which]
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("op", ["state_scan", "pow2_linear", "causal_attention"])
def test_lm_op_with_use_kernel_on_cpu_tensors_raises(op):
    """``use_kernel=True`` asks for the CUDA kernel: on CPU tensors it
    raises instead of running the plain version; ``None`` and ``False``
    run the plain version there."""
    from repro_torch.kernels import causal_attention, pow2_linear, state_scan

    args = {"state_scan": (torch.zeros((1, 2, 4, 4, 4)), torch.ones((1, 2, 4))),
            "pow2_linear": (torch.zeros((2, 4, 8)), torch.zeros((8, 4), dtype=torch.uint8)),
            "causal_attention": tuple([torch.zeros((2, 16, 8))] * 3)}[op]
    fn = {"state_scan": state_scan, "pow2_linear": pow2_linear,
          "causal_attention": causal_attention}[op]
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(*args, use_kernel=True)
    assert fn(*args, use_kernel=None).device.type == "cpu"
    assert torch.equal(fn(*args, use_kernel=False), fn(*args))


@pytest.mark.parametrize("kw,exc,match", [
    # A12a (the per-lane budget gate) is ported: the budget is accepted
    (dict(generations_budget=5), None, None),
    # A11 (batching) is ported: its one lane axis is engine.BATCH_AXIS, and
    # any other axis name is refused
    (dict(batch_axis="runs"), ValueError, "ga_runs")], ids=["kw1-A12", "kw2-A11"])
def test_unported_config_paths_raise(kw, exc, match):
    if exc is None:
        assert GAConfig(**kw).generations_budget == kw["generations_budget"]
        return
    with pytest.raises(exc, match=match):
        GAConfig(**kw)
    if exc is ValueError:
        assert GAConfig(batch_axis=engine.BATCH_AXIS).batch_axis == "ga_runs"


def test_variation_mode_builds_and_rejects_the_jnp_oracle():
    for mode in ("mean", "worst"):
        assert GAConfig(variation_mode=mode).variation_mode == mode
    with pytest.raises(ValueError, match="jnp"):
        GAConfig(variation_mode="worst", backends=BackendPolicy(fitness="jnp"))


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
    """The "jnp" oracle averages over padded samples and ignores the output
    mask, so a padded problem refuses it: ``pad_problem`` as the reference
    does, and a Problem built with padded leaves too."""
    from repro_torch.core.genome import GenomeSpec, max_topology

    ds = bc_dataset
    cfg = GAConfig(backends=BackendPolicy(fitness="jnp"))
    p = engine.Problem.from_data(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                                 cfg, device="cpu")
    p.replace_cfg(seed=3)        # re-validating an unpadded problem is fine
    with pytest.raises(ValueError, match="count-based"):
        engine.Problem(p.x_int, p.labels, p.baseline_acc, p.spec, cfg,
                       out_mask=torch.as_tensor(np.array([1, 0], np.int32)))
    spec_pad = GenomeSpec(max_topology([MLPTopology(ds.topology),
                                        MLPTopology((11, 4, 6))]))
    with pytest.raises(ValueError, match="count-based"):
        engine.pad_problem(p, spec_pad)


def _launchers() -> dict:
    """name → parameter list of every ``extern "C" int *_launch(...)`` in
    the port's CUDA sources."""
    found = {}
    for path in sorted(_cuda.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+_launch)\(([^)]*)\)',
                                       path.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = [" ".join(p.split()) for p in params.split(",")]
    return found


def _ctype(param: str):
    """The ctypes type a C parameter is bound with: a pointer c_void_p, an
    int c_int, a float c_float (the launchers take nothing else)."""
    if "*" in param:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "float": ctypes.c_float}[" ".join(param.split()[:-1])]


def test_every_launcher_has_a_signature():
    assert set(_launchers()) == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_launcher_signature_matches_its_source(name):
    params = _launchers()[name]
    assert len(params) == len(_cuda._SIGNATURES[name]), params
    assert tuple(map(_ctype, params)) == _cuda._SIGNATURES[name], params
