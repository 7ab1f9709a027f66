"""Verilog emission for an evolved approximate MLP (paper Fig. 2, "HDL").

A copy of ``repro.core.hdl`` (numpy only) on the port's ``GenomeSpec``, so
the port emits the same text without importing the JAX package; the
header line of the emitted module is the reference's, so both packages
emit identical Verilog for a genome.

The generated module mirrors the bespoke circuit of paper Fig. 1:
  * pow2 multiplication = wire shift of the masked input,
  * bit-mask pruning = masked-out bits wired to constant 0 (they then vanish
    in synthesis — paper §III-B),
  * sign = hardwired add/subtract,
  * QReLU = clamp + LSB drop (the rshift gene),
  * biases folded in as constants.

Synthesis (Synopsys + EGFET lib) is outside this container; the emitted RTL
is self-contained behavioural Verilog. ``evaluate_genome_python`` is a
pure-python integer simulator with the exact circuit semantics; tests assert
it matches ``repro_torch.core.mlp.mlp_forward`` bit-for-bit, which
transitively validates the RTL's arithmetic structure.
"""
from __future__ import annotations

import numpy as np

from .genome import GenomeSpec

ACC_BITS = 24  # accumulator width: covers the paper's topologies with margin


def _masked_concat(sig: str, mask: int, in_bits: int) -> str:
    """{..} keeping masked-out bits as constant 0."""
    parts = []
    for b in reversed(range(in_bits)):
        parts.append(f"{sig}[{b}]" if mask & (1 << b) else "1'b0")
    return "{" + ", ".join(parts) + "}"


def emit_verilog(spec: GenomeSpec, genome: np.ndarray,
                 name: str = "approx_mlp") -> str:
    genome = np.asarray(genome)
    topo = spec.topo
    out: list[str] = []
    w = out.append
    n_in, n_out = topo.sizes[0], topo.sizes[-1]

    w("// Auto-generated by repro.core.hdl - approximate printed MLP")
    w(f"// topology {topo.sizes}, inputs {topo.input_bits}b, acts {topo.act_bits}b")
    w(f"module {name} (")
    for i in range(n_in):
        w(f"  input  wire [{topo.input_bits - 1}:0] x0_{i},")
    for j in range(n_out):
        comma = "," if j < n_out - 1 else ""
        w(f"  output wire signed [{ACC_BITS - 1}:0] y_{j}{comma}")
    w(");")

    for l, sl in enumerate(spec.layers):
        masks = genome[sl.masks].reshape(sl.fan_in, sl.fan_out)
        signs = genome[sl.signs].reshape(sl.fan_in, sl.fan_out) * 2 - 1
        exps = genome[sl.exps].reshape(sl.fan_in, sl.fan_out)
        bias = genome[sl.biases]
        bshift = int(genome[sl.bshift.start])
        rshift = int(genome[sl.rshift.start])
        last = l == len(spec.layers) - 1
        pad = ACC_BITS - sl.in_bits
        w(f"  // ---- layer {l} ({sl.fan_in} -> {sl.fan_out}) ----")
        for j in range(sl.fan_out):
            terms: list[tuple[str, str]] = []
            for i in range(sl.fan_in):
                m = int(masks[i, j])
                if m == 0:
                    continue  # zero mask == pruned summand (paper §III-B)
                tname = f"t{l}_{j}_{i}"
                cc = _masked_concat(f"x{l}_{i}", m, sl.in_bits)
                # zero-extend to ACC_BITS *before* the constant shift so no
                # bits are lost (verilog shifts keep operand width)
                w(f"  wire [{ACC_BITS - 1}:0] {tname} = "
                  f"({{{{{pad}{{1'b0}}}}, {cc}}} << {int(exps[i, j])});")
                terms.append(("-" if signs[i, j] < 0 else "+", tname))
            bias_val = int(bias[j]) << bshift
            acc = f"acc{l}_{j}"
            rhs = " ".join(f"{s} $signed({t})" for s, t in terms)
            rhs = (rhs + f" + $signed({ACC_BITS}'sd{abs(bias_val)})"
                   if bias_val >= 0 else
                   rhs + f" - $signed({ACC_BITS}'sd{abs(bias_val)})")
            rhs = rhs.lstrip("+ ").strip() or "0"
            w(f"  wire signed [{ACC_BITS - 1}:0] {acc} = {rhs};")
            if last:
                w(f"  assign y_{j} = {acc};")
            else:
                q = f"x{l + 1}_{j}"
                hi = 2**topo.act_bits - 1
                w(f"  wire [{topo.act_bits - 1}:0] {q} = ({acc} < 0) ? "
                  f"{topo.act_bits}'d0 : (({acc} >>> {rshift}) > {hi}) ? "
                  f"{topo.act_bits}'d{hi} : ({acc} >>> {rshift});")
    w("endmodule")
    return "\n".join(out) + "\n"


def evaluate_genome_python(spec: GenomeSpec, genome: np.ndarray,
                           x_int: np.ndarray) -> np.ndarray:
    """Pure-python integer simulator with hardware semantics (per-sample)."""
    genome = np.asarray(genome)
    topo = spec.topo
    outs = []
    for sample in np.asarray(x_int, np.int64):
        h = [int(v) for v in sample]
        for l, sl in enumerate(spec.layers):
            masks = genome[sl.masks].reshape(sl.fan_in, sl.fan_out)
            signs = genome[sl.signs].reshape(sl.fan_in, sl.fan_out) * 2 - 1
            exps = genome[sl.exps].reshape(sl.fan_in, sl.fan_out)
            bias = genome[sl.biases]
            bshift = int(genome[sl.bshift.start])
            rshift = int(genome[sl.rshift.start])
            nxt = []
            for j in range(sl.fan_out):
                acc = int(bias[j]) << bshift
                for i in range(sl.fan_in):
                    acc += int(signs[i, j]) * ((h[i] & int(masks[i, j]))
                                               << int(exps[i, j]))
                if l == len(spec.layers) - 1:
                    nxt.append(acc)
                else:
                    v = acc >> rshift  # python >> is arithmetic for ints
                    nxt.append(min(max(v, 0), 2**topo.act_bits - 1))
            h = nxt
        outs.append(h)
    return np.asarray(outs, np.int64)


def evaluate_genome_instances(spec: GenomeSpec, genome: np.ndarray,
                              x_int: np.ndarray,
                              deltas: np.ndarray) -> np.ndarray:
    """Per-device-instance oracle for the variation-aware MC fitness.

    ``deltas`` is (K, G) int32 exponent perturbations
    (``engine.device_deltas``); instance ``k`` evaluates the genome with
    ``where(d == 0, g, clip(g + d, 0, high - 1))`` applied — the exact
    integer rule of ``genome.apply_device_deltas`` — through the
    pure-python hardware simulator. Returns (K, S, n_out) int64 logits.
    """
    genome = np.asarray(genome)
    high = np.asarray(spec.high)
    outs = []
    for d in np.asarray(deltas):
        g = np.where(d == 0, genome, np.clip(genome + d, 0, high - 1))
        outs.append(evaluate_genome_python(spec, g, x_int))
    return np.stack(outs, axis=0)


def emit_testbench(spec: GenomeSpec, name: str = "approx_mlp") -> str:
    """Minimal TB skeleton driving random vectors (for external simulators)."""
    topo = spec.topo
    n_in = topo.sizes[0]
    lines = [f"module {name}_tb;"]
    for i in range(n_in):
        lines.append(f"  reg [{topo.input_bits - 1}:0] x0_{i};")
    for j in range(topo.sizes[-1]):
        lines.append(f"  wire signed [{ACC_BITS - 1}:0] y_{j};")
    ports = ", ".join([f".x0_{i}(x0_{i})" for i in range(n_in)]
                      + [f".y_{j}(y_{j})" for j in range(topo.sizes[-1])])
    lines += [f"  {name} dut ({ports});",
              "  initial begin", "    $dumpvars;", "    #1 $finish;",
              "  end", "endmodule"]
    return "\n".join(lines) + "\n"
