"""Wrapper of the CUDA megakernel ``pop_generation_kernel``
(``csrc/pop_generation.cu``), both branches.

Replaces the Pallas TPU kernel ``repro/kernels/pop_generation/kernel.py:
pop_generation_kernel``: pre-gathered parent frames + the dataset → ((P, G)
int32 children, (P,) int32 correct counts). Each tile's children are made
by the variation math of ``pop_variation`` and scored by the fitness math
of ``pop_mlp`` without leaving the block's shared memory. Every child is
evaluated, from the tables of per-instance weight multipliers of
``pop_mlp_correct_mc`` built for the children in the block at one
instance, as ``pop_mlp_correct`` runs them. Its ``n_dev`` branch (``dev``,
a (K, G) device-variation delta table) scores each child on the K
perturbed device instances instead: (P, K) counts, the same children. The
launchers' ``pop_generation_smem_bytes`` and
``pop_generation_mc_smem_bytes`` give each branch's shared memory per
block, which the wrapper checks.

Every operand may carry a leading lane axis: L independent populations made
and scored in one launch (a single one is the case L = 1).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`pop_generation_plain`.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from .. import _cuda
from ..pop_mlp.kernel import (check_deltas, net_desc, out_mask_or_ones,
                              pop_mlp_correct_mc_plain, pop_mlp_correct_plain)
from ..pop_variation.kernel import (VARIATION_OPERANDS, pop_variation_plain,
                                    variation_operands)


def pop_generation_plain(a_rows, b_rows, do_rows, table_low, table_high,
                         table_is_mask, table_mask_bits, table_ids, slot_keys,
                         pm_gene, x_int, labels, *, spec: GenomeSpec,
                         n_valid_samples=None, out_mask=None, dev=None):
    """The kernel's plain PyTorch version: the variation kernel's plain
    version, then the fitness kernel's (with ``dev``, the device-instance
    one against the bounds ``table_high``), with no row bound; lanes
    too."""
    children = pop_variation_plain(a_rows, b_rows, do_rows, table_low,
                                   table_high, table_is_mask, table_mask_bits,
                                   table_ids, slot_keys, pm_gene)
    if dev is not None:
        return children, pop_mlp_correct_mc_plain(
            children, x_int, labels, spec=spec, dev=dev, gene_high=table_high,
            n_valid_samples=n_valid_samples, out_mask=out_mask)
    counts = pop_mlp_correct_plain(children, x_int, labels, spec=spec,
                                   n_valid_samples=n_valid_samples,
                                   out_mask=out_mask)
    return children, counts


def pop_generation_call(a_rows, b_rows, do_rows, table_low, table_high,
                        table_is_mask, table_mask_bits, table_ids, slot_keys,
                        pm_gene, x_int, labels, *, spec: GenomeSpec,
                        n_valid_samples=None, out_mask=None, dev=None):
    """The checked launch of the kernel on CUDA tensors, and the children
    and zeroed counts it fills → (launch, children, counts) (arguments as
    :func:`pop_generation_kernel`; P, G > 0). With ``dev`` it is the
    ``n_dev`` branch, counted as ``pop_generation_kernel_mc``."""
    deltas, dev = dev, a_rows.device
    if dev.type != "cuda":
        raise ValueError(f"pop_generation_kernel launches on CUDA tensors, got {dev}")
    single, o = variation_operands(a_rows, b_rows, do_rows, table_low, table_high,
                                   table_is_mask, table_mask_bits, table_ids,
                                   slot_keys, pm_gene)
    if single:
        x_int, labels = x_int[None], labels[None]
        out_mask = None if out_mask is None else out_mask[None]
        deltas = None if deltas is None else deltas[None]
    L, P, G = o["a_rows"].shape
    S, n_in = x_int.shape[1:]
    n_out = spec.topo.sizes[-1]
    if G != spec.n_genes or n_in != spec.topo.sizes[0]:
        raise ValueError(f"shapes a_rows {tuple(a_rows.shape)} / x "
                         f"{tuple(x_int.shape)} do not fit topology {spec.topo.sizes}")
    desc = _cuda.host_ints(net_desc(spec))
    _cuda.check(x_int, "x_int", torch.int32, (L, S, n_in), dev)
    _cuda.check(labels, "labels", torch.int32, (L, S), dev)
    om = out_mask_or_ones(out_mask, (L, n_out), dev)
    _cuda.check(om, "out_mask", torch.int32, (L, n_out), dev)
    samp = _cuda.lane_bounds(n_valid_samples, S, L, dev)
    children = torch.empty((L, P, G), dtype=torch.int32, device=dev)
    head = (*(o[k].data_ptr() for k in VARIATION_OPERANDS), L, P, G, x_int.data_ptr(),
            labels.data_ptr(), S, n_in, samp.data_ptr(), om.data_ptr())
    keep = (*o.values(), x_int, labels, samp, om, desc, children)
    lib = _cuda.library()
    if deltas is None:
        _cuda.check_smem(lib.pop_generation_smem_bytes(desc, G), dev,
                         f"pop_generation_kernel at {spec.topo.sizes}")
        counts = torch.zeros((L, P), dtype=torch.int32, device=dev)
        launch = _cuda.Launch("pop_generation_kernel", "pop_generation_launch",
                              (*head, desc, children.data_ptr(), counts.data_ptr()),
                              (*keep, counts))
    else:
        d, _ = check_deltas(deltas, o["high"], L, G, dev,
                            lambda K: lib.pop_generation_mc_smem_bytes(desc, G, K))
        counts = torch.zeros((L, P, d.shape[1]), dtype=torch.int32, device=dev)
        launch = _cuda.Launch("pop_generation_kernel_mc", "pop_generation_mc_launch",
                              (*head, d.data_ptr(), d.shape[1], desc, children.data_ptr(),
                               counts.data_ptr()), (*keep, d, counts))
    if single:
        return launch, children[0], counts[0]
    return launch, children, counts


def pop_generation_kernel(a_rows, b_rows, do_rows, table_low, table_high,
                          table_is_mask, table_mask_bits, table_ids,
                          slot_keys, pm_gene, x_int, labels, *,
                          spec: GenomeSpec, n_valid_samples=None,
                          out_mask=None, dev=None):
    """Parent frames (see ``pop_variation_kernel``) + dataset →
    (children, counts). ``n_valid_samples`` (int or () int32 device
    tensor) bounds the counted samples; ``out_mask`` marks the valid output
    columns. ``dev`` ((K, G) deltas, zero off the exponent genes): the
    counts are (P, K), child p on device instance k, its exponents clipped
    into ``[0, table_high - 1]``.

    Lanes: the variation operands as ``pop_variation_kernel`` takes them,
    x_int (L, S, n_in), labels (L, S), n_valid_samples () or (L,),
    out_mask (L, n_out), dev (L, K, G) → (L, P, G) children and (L, P) or
    (L, P, K) counts in one launch."""
    if a_rows.device.type == "cpu":
        return pop_generation_plain(a_rows, b_rows, do_rows, table_low,
                                    table_high, table_is_mask, table_mask_bits,
                                    table_ids, slot_keys, pm_gene, x_int,
                                    labels, spec=spec,
                                    n_valid_samples=n_valid_samples,
                                    out_mask=out_mask, dev=dev)
    launch, children, counts = pop_generation_call(
        a_rows, b_rows, do_rows, table_low, table_high, table_is_mask,
        table_mask_bits, table_ids, slot_keys, pm_gene, x_int, labels,
        spec=spec, n_valid_samples=n_valid_samples, out_mask=out_mask, dev=dev)
    if children.numel():
        launch()
    return children, counts
