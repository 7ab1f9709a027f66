"""Wrapper of the CUDA kernel ``pop_mlp_correct`` (``csrc/pop_mlp.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pop_mlp/kernel.py:
pop_mlp_correct``: (P, G) int32 genomes × (S, n_in) int32 samples × (S,)
int32 labels → (P,) int32 correct counts of the integer approximate MLP.
The source's header says what bounds it on the card and how it is laid out.

On a CUDA tensor the wrapper checks its inputs and launches the kernel on
the current stream; on a CPU tensor it runs the plain version
(``ref.pop_mlp_correct_tiled``). It never falls back from one to the other.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from .. import _cuda
from .ref import pop_mlp_correct_tiled

MAX_LAYERS = 4   # csrc/common.cuh kMaxLayers
MAX_WIDTH = 32   # csrc/common.cuh kMaxWidth


def net_desc(spec: GenomeSpec) -> list[int]:
    """The kernels' layer descriptor: [n_layers, act_max] then, per layer,
    the gene offsets of masks/signs/exps/biases/bshift/rshift and the fan
    in/out (``csrc/common.cuh`` ``Layer``)."""
    topo = spec.topo
    if topo.n_layers > MAX_LAYERS or max(topo.sizes) > MAX_WIDTH:
        raise ValueError(f"topology {topo.sizes} exceeds the CUDA kernels' "
                         f"{MAX_LAYERS} layers of width <= {MAX_WIDTH}")
    d = [topo.n_layers, 2**topo.act_bits - 1]
    for sl in spec.layers:
        d += [sl.masks.start, sl.signs.start, sl.exps.start, sl.biases.start,
              sl.bshift.start, sl.rshift.start, sl.fan_in, sl.fan_out]
    return d


def out_mask_or_ones(out_mask, n_out: int, device) -> torch.Tensor:
    if out_mask is None:
        return torch.ones(n_out, dtype=torch.int32, device=device)
    return out_mask.to(device=device, dtype=torch.int32).contiguous()


# The kernel's plain PyTorch version: same counts, rows past n_valid_rows 0,
# samples past n_valid_samples not counted.
pop_mlp_correct_plain = pop_mlp_correct_tiled


def pop_mlp_correct_call(pop, x_int, labels, *, spec: GenomeSpec,
                         n_valid_rows=None, n_valid_samples=None,
                         out_mask=None) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the zeroed
    counts it adds into (arguments as :func:`pop_mlp_correct`; P > 0)."""
    dev = pop.device
    if dev.type != "cuda":
        raise ValueError(f"pop_mlp_correct launches on CUDA tensors, got {dev}")
    P, G = pop.shape
    S, n_in = x_int.shape
    n_out = spec.topo.sizes[-1]
    if G != spec.n_genes or n_in != spec.topo.sizes[0]:
        raise ValueError(f"shapes pop {tuple(pop.shape)} / x {tuple(x_int.shape)} "
                         f"do not fit topology {spec.topo.sizes}")
    desc = _cuda.host_ints(net_desc(spec))
    _cuda.check(pop, "pop", torch.int32, (P, G), dev)
    _cuda.check(x_int, "x_int", torch.int32, (S, n_in), dev)
    _cuda.check(labels, "labels", torch.int32, (S,), dev)
    om = out_mask_or_ones(out_mask, n_out, dev)
    _cuda.check(om, "out_mask", torch.int32, (n_out,), dev)
    rows = _cuda.device_scalar(n_valid_rows, P, dev)
    samp = _cuda.device_scalar(n_valid_samples, S, dev)
    counts = torch.zeros(P, dtype=torch.int32, device=dev)
    keep = (pop, x_int, labels, rows, samp, om, desc, counts)
    args = (pop.data_ptr(), P, G, x_int.data_ptr(), labels.data_ptr(), S, n_in,
            rows.data_ptr(), samp.data_ptr(), om.data_ptr(), desc, counts.data_ptr())
    return _cuda.Launch("pop_mlp_correct", "pop_mlp_correct_launch", args, keep), counts


def pop_mlp_correct(pop, x_int, labels, *, spec: GenomeSpec,
                    n_valid_rows=None, n_valid_samples=None,
                    out_mask=None) -> torch.Tensor:
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts.

    ``n_valid_rows``/``n_valid_samples``: optional bounds (ints or ()
    int32 tensors on the device — the kernel reads them there, so a bound
    computed on the card costs no synchronisation). Rows at or past
    ``n_valid_rows`` come back 0; samples at or past ``n_valid_samples``
    are not counted. ``out_mask`` ((n_out,)): zero marks an invalid
    output column. Labels of −1 never match."""
    if pop.device.type == "cpu":
        return pop_mlp_correct_plain(pop, x_int, labels, spec=spec,
                                     n_valid_rows=n_valid_rows,
                                     n_valid_samples=n_valid_samples,
                                     out_mask=out_mask)
    launch, counts = pop_mlp_correct_call(pop, x_int, labels, spec=spec,
                                          n_valid_rows=n_valid_rows,
                                          n_valid_samples=n_valid_samples,
                                          out_mask=out_mask)
    if pop.shape[0]:
        launch()
    return counts
