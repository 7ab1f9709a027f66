"""The port's backend fallback chains and their probe kernel, against the
reference's (``tests/test_supervisor.py::TestBackendFallback``): with an
injected probe, ``resolve_backends(fallback=True)`` degrades along the
port's chains (kernel → ref, sweep → matrix), warns once per downgrade,
leaves a healthy policy alone and changes nothing without ``fallback``.
On this host the real probe answers False (no CUDA) without building
anything. The reference's chains go through "interpret", which the port
does not have; where the reference's probe refuses "interpret" as well,
both resolve a policy to the same backends."""
import warnings

import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import through its core)
import repro.kernels as jk
from repro_torch.kernels import _cuda, backend
from repro_torch.kernels.backend import (FALLBACK_CHAINS, BackendPolicy,
                                         backend_available, resolve_backends)
from repro_torch.kernels.probe import PROBE_SHAPE, probe_call, probe_kernel, probe_plain


@pytest.fixture(autouse=True)
def _fresh_memo(monkeypatch):
    monkeypatch.setattr(backend, "_KERNEL_OK", {})
    monkeypatch.setattr(backend, "_WARNED", set())
    monkeypatch.setattr(jk, "_PALLAS_OK", {})
    monkeypatch.setattr(jk, "_WARNED", set())


def test_unavailable_kernel_degrades_down_the_chain():
    probe = lambda path, name: name != "kernel"          # noqa: E731
    with pytest.warns(RuntimeWarning, match="falling back to 'ref'"):
        got = resolve_backends(BackendPolicy(fitness="kernel"), fallback=True, probe=probe)
    assert got == BackendPolicy(fitness="ref")


@pytest.mark.parametrize("policy", [
    dict(fitness="kernel", variation="kernel", ranking="sweep"),
    dict(generation="kernel", variation="ref", ranking="matrix"),
    dict(fitness="kernel", generation="phases", ranking="sweep")])
def test_degrades_as_the_reference_when_interpret_also_fails(policy):
    probe = lambda path, name: name in ("ref", "matrix")  # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = resolve_backends(BackendPolicy(**policy), fallback=True, probe=probe)
        ref = jk.resolve_backends(jk.BackendPolicy(**policy), fallback=True, probe=probe)
    for path in ("fitness", "variation", "generation", "ranking"):
        assert getattr(got, path) == getattr(ref, path), path
    assert "kernel" not in (got.fitness, got.variation, got.generation)
    assert got.ranking == "matrix"


def test_nothing_probes_healthy_keeps_the_last_entry_and_warns():
    probe = lambda path, name: False                     # noqa: E731
    with pytest.warns(RuntimeWarning, match="no probed fallback; using 'ref'"):
        got = resolve_backends(BackendPolicy(fitness="kernel"), fallback=True, probe=probe)
    assert got.fitness == "ref"


def test_available_backend_untouched_no_warning():
    probe = lambda path, name: True                      # noqa: E731
    pol = BackendPolicy(fitness="kernel", variation="kernel", generation="kernel",
                        ranking="sweep")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_backends(pol, fallback=True, probe=probe) == pol


def test_warns_once_per_downgrade():
    probe = lambda path, name: name != "kernel"          # noqa: E731
    with pytest.warns(RuntimeWarning):
        resolve_backends(BackendPolicy(fitness="kernel"), fallback=True, probe=probe)
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the same downgrade again: silent
        assert resolve_backends(BackendPolicy(fitness="kernel"), fallback=True,
                                probe=probe).fitness == "ref"
    with pytest.warns(RuntimeWarning):        # another path warns on its own
        resolve_backends(BackendPolicy(variation="kernel"), fallback=True, probe=probe)


def test_fallback_off_preserves_policy():
    probe = lambda path, name: False                     # noqa: E731
    pol = BackendPolicy(fitness="kernel", ranking="sweep")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_backends(pol, probe=probe) == pol
        assert resolve_backends(pol) == pol


def test_names_outside_a_chain_are_never_downgraded():
    probe = lambda path, name: False                     # noqa: E731
    pol = BackendPolicy(fitness="jnp", variation="ops", generation="phases",
                        ranking="matrix")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_backends(pol, fallback=True, probe=probe) == pol
        assert resolve_backends(BackendPolicy(), fallback=True, probe=probe) == BackendPolicy()
    assert FALLBACK_CHAINS == {"fitness": ("kernel", "ref"), "variation": ("kernel", "ref"),
                               "generation": ("kernel", "ref"), "ranking": ("sweep", "matrix")}


def test_real_probe_without_cuda_is_false_builds_nothing_and_is_memoized(monkeypatch):
    built = []
    monkeypatch.setattr(_cuda, "build", lambda: built.append(1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = dict(_cuda.LAUNCHES)
    assert not backend_available("fitness", "kernel")
    assert backend._KERNEL_OK == {"compiled": False}
    assert backend_available("fitness", "ref") and backend_available("ranking", "sweep")
    with pytest.warns(RuntimeWarning, match="falling back to 'ref'"):
        got = resolve_backends(BackendPolicy(fitness="kernel", generation="kernel"),
                               fallback=True)
    assert (got.fitness, got.generation) == ("ref", "ref")
    assert built == [] and _cuda.LAUNCHES == before
    # the memo answers from now on; a reset asks again
    monkeypatch.setattr(backend, "_KERNEL_OK", {"compiled": True})
    assert backend_available("fitness", "kernel")
    monkeypatch.setattr(backend, "_KERNEL_OK", {})
    assert not backend_available("variation", "kernel")


def test_probe_plain_and_its_launch_refusing_cpu_tensors():
    x = torch.zeros(PROBE_SHAPE, dtype=torch.int32)
    x[3, 5] = 41
    out = probe_kernel(x)                     # a CPU tensor runs the plain version
    assert torch.equal(out, probe_plain(x)) and out[0, 0] == 1 and out[3, 5] == 42
    with pytest.raises(ValueError, match="CUDA"):
        probe_call(x)


def test_no_entry_point_of_the_port_turns_fallback_on():
    """``fallback=True`` is the caller's opt-in: no call in the port passes
    ``fallback`` at all; ``chip_smoke.py`` passes it only in its probe
    phase, which checks that nothing is downgraded on the card."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for path in [*(root / "src" / "repro_torch").rglob("*.py"), root / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "fallback":
                        assert path.name == "chip_smoke.py", f"{path}:{node.lineno}"
