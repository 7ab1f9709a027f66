"""Wrapper of the CUDA megakernel ``pop_generation_kernel``
(``csrc/pop_generation.cu``), nominal branch.

Replaces the Pallas TPU kernel ``repro/kernels/pop_generation/kernel.py:
pop_generation_kernel`` without its device-variation ``n_dev`` branch:
pre-gathered parent frames + the dataset → ((P, G) int32 children, (P,)
int32 correct counts). Each tile's children are made by the variation math
of ``pop_variation`` and scored by the fitness math of ``pop_mlp`` without
leaving the block's shared memory. Every child is evaluated.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`pop_generation_plain`.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from .. import _cuda
from ..pop_mlp.kernel import net_desc, out_mask_or_ones, pop_mlp_correct_plain
from ..pop_variation.kernel import (VARIATION_OPERANDS, pop_variation_plain,
                                    variation_operands)


def pop_generation_plain(a_rows, b_rows, do_rows, table_low, table_high,
                         table_is_mask, table_mask_bits, table_ids, slot_keys,
                         pm_gene, x_int, labels, *, spec: GenomeSpec,
                         n_valid_samples=None, out_mask=None):
    """The kernel's plain PyTorch version: the variation kernel's plain
    version, then the fitness kernel's, with no row bound."""
    children = pop_variation_plain(a_rows, b_rows, do_rows, table_low,
                                   table_high, table_is_mask, table_mask_bits,
                                   table_ids, slot_keys, pm_gene)
    counts = pop_mlp_correct_plain(children, x_int, labels, spec=spec,
                                   n_valid_samples=n_valid_samples,
                                   out_mask=out_mask)
    return children, counts


def pop_generation_call(a_rows, b_rows, do_rows, table_low, table_high,
                        table_is_mask, table_mask_bits, table_ids, slot_keys,
                        pm_gene, x_int, labels, *, spec: GenomeSpec,
                        n_valid_samples=None, out_mask=None):
    """The checked launch of the kernel on CUDA tensors, and the children
    and zeroed counts it fills → (launch, children, counts) (arguments as
    :func:`pop_generation_kernel`; P, G > 0)."""
    dev = a_rows.device
    if dev.type != "cuda":
        raise ValueError(f"pop_generation_kernel launches on CUDA tensors, got {dev}")
    P, G = a_rows.shape
    S, n_in = x_int.shape
    n_out = spec.topo.sizes[-1]
    if G != spec.n_genes or n_in != spec.topo.sizes[0]:
        raise ValueError(f"shapes a_rows {tuple(a_rows.shape)} / x "
                         f"{tuple(x_int.shape)} do not fit topology {spec.topo.sizes}")
    desc = _cuda.host_ints(net_desc(spec))
    o = variation_operands(a_rows, b_rows, do_rows, table_low, table_high,
                           table_is_mask, table_mask_bits, table_ids,
                           slot_keys, pm_gene)
    _cuda.check(x_int, "x_int", torch.int32, (S, n_in), dev)
    _cuda.check(labels, "labels", torch.int32, (S,), dev)
    om = out_mask_or_ones(out_mask, n_out, dev)
    _cuda.check(om, "out_mask", torch.int32, (n_out,), dev)
    samp = _cuda.device_scalar(n_valid_samples, S, dev)
    children = torch.empty((P, G), dtype=torch.int32, device=dev)
    counts = torch.zeros(P, dtype=torch.int32, device=dev)
    args = (*(o[k].data_ptr() for k in VARIATION_OPERANDS), P, G, x_int.data_ptr(),
            labels.data_ptr(), S, n_in, samp.data_ptr(), om.data_ptr(), desc,
            children.data_ptr(), counts.data_ptr())
    keep = (*o.values(), x_int, labels, samp, om, desc, children, counts)
    return (_cuda.Launch("pop_generation_kernel", "pop_generation_launch", args, keep),
            children, counts)


def pop_generation_kernel(a_rows, b_rows, do_rows, table_low, table_high,
                          table_is_mask, table_mask_bits, table_ids,
                          slot_keys, pm_gene, x_int, labels, *,
                          spec: GenomeSpec, n_valid_samples=None,
                          out_mask=None):
    """Parent frames (see ``pop_variation_kernel``) + dataset →
    (children, counts). ``n_valid_samples`` (int or () int32 device
    tensor) bounds the counted samples; ``out_mask`` marks the valid output
    columns."""
    if a_rows.device.type == "cpu":
        return pop_generation_plain(a_rows, b_rows, do_rows, table_low,
                                    table_high, table_is_mask, table_mask_bits,
                                    table_ids, slot_keys, pm_gene, x_int,
                                    labels, spec=spec,
                                    n_valid_samples=n_valid_samples,
                                    out_mask=out_mask)
    launch, children, counts = pop_generation_call(
        a_rows, b_rows, do_rows, table_low, table_high, table_is_mask,
        table_mask_bits, table_ids, slot_keys, pm_gene, x_int, labels,
        spec=spec, n_valid_samples=n_valid_samples, out_mask=out_mask)
    if children.numel():
        launch()
    return children, counts
