"""The port's Verilog emission and integer circuit simulators against the
reference's: the same module and testbench text, the same simulated
logits (and the port's forward's), per device instance too; tolerance 0."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import genome as jg, hdl as jhdl
from repro_torch.core import genome as tg, hdl as thdl, mlp as tmlp
from test_torch_interop import assert_bits_equal

TOPOS = [(10, 3, 2), (6, 4, 3), (5, 4, 3, 2), (16, 5, 10)]


def _genomes(spec, n=3, seed=0):
    """Random in-bounds genomes; the first with some masks cleared (pruned
    summands) and its biases negative."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(spec.low, spec.high, (n, spec.n_genes)).astype(np.int32)
    sl = spec.layers[0]
    pop[0, sl.masks.start:sl.masks.start + sl.fan_in] = 0
    for s in spec.layers:
        pop[0, s.biases] = np.maximum(-np.abs(pop[0, s.biases]) - 1, spec.low[s.biases])
    return pop


def _specs(sizes):
    return jg.GenomeSpec(jg.MLPTopology(sizes)), tg.GenomeSpec(tg.MLPTopology(sizes))


@pytest.mark.parametrize("sizes", TOPOS)
def test_layer_slices_match_reference(sizes):
    """``hdl`` reads the layout through ``LayerSlices``: the same fields
    holding the same slices."""
    spec_j, spec_t = _specs(sizes)
    names = [f.name for f in dataclasses.fields(tg.LayerSlices)]
    assert names == [f.name for f in dataclasses.fields(jg.LayerSlices)]
    assert spec_t.layers == [tg.LayerSlices(**dataclasses.asdict(s)) for s in spec_j.layers]
    assert_bits_equal(np.asarray(spec_j.table().high), spec_t.high, "gene bounds")


@pytest.mark.parametrize("sizes", TOPOS)
def test_emit_verilog_and_testbench_match_reference(sizes):
    spec_j, spec_t = _specs(sizes)
    for i, g in enumerate(_genomes(spec_t)):
        want = jhdl.emit_verilog(spec_j, g, name=f"mlp_{i}")
        assert thdl.emit_verilog(spec_t, g, name=f"mlp_{i}") == want
    assert thdl.emit_verilog(spec_t, g) == jhdl.emit_verilog(spec_j, g)
    assert thdl.emit_testbench(spec_t, name="tb_mlp") == jhdl.emit_testbench(spec_j,
                                                                              name="tb_mlp")
    assert thdl.emit_testbench(spec_t) == jhdl.emit_testbench(spec_j)


@pytest.mark.parametrize("sizes", TOPOS)
def test_circuit_simulators_match_reference(sizes):
    """``evaluate_genome_python`` equals the reference's and the port's
    forward; ``evaluate_genome_instances`` equals the reference's over
    device-instance exponent deltas."""
    spec_j, spec_t = _specs(sizes)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 16, (23, sizes[0])).astype(np.int32)
    deltas = np.where(spec_t.is_exp, rng.integers(-1, 2, (3, spec_t.n_genes)),
                      0).astype(np.int32)
    for g in _genomes(spec_t, seed=1):
        got = thdl.evaluate_genome_python(spec_t, g, x)
        assert_bits_equal(jhdl.evaluate_genome_python(spec_j, g, x), got, "python sim")
        assert_bits_equal(got, tmlp.mlp_forward(spec_t, torch.as_tensor(g),
                                                torch.as_tensor(x)).numpy().astype(np.int64),
                          "sim vs forward")
        assert_bits_equal(jhdl.evaluate_genome_instances(spec_j, g, x, deltas),
                          thdl.evaluate_genome_instances(spec_t, g, x, deltas), "instances")
