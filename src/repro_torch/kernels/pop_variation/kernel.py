"""Wrapper of the CUDA kernel ``pop_variation_kernel``
(``csrc/pop_variation.cu``).

Replaces the Pallas TPU kernel ``repro/kernels/pop_variation/kernel.py:
pop_variation_kernel``: (P, G) children from pre-gathered parent frames,
with every gene-shaped uniform drawn inside the kernel by the counter-based
Threefry-2x32 of ``core.genome``.

Child-frame layout (the dispatcher builds it): ``a_rows[p]`` is child
``p``'s no-swap source and ``b_rows[p]`` its swap source — row ``p <
P/2`` is pair ``p``, row ``P/2 + p`` the same pair with the roles flipped.
The swap draw belongs to the pair, so its counter row is ``p mod P/2``;
the mutation slots use the child row ``p``.

Every operand may carry a leading lane axis: L independent populations
varied in one launch (a single one is the case L = 1).

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
:func:`pop_variation_plain`, the same math in PyTorch.
"""
from __future__ import annotations

import torch

from ...core.genome import bits_to_open01, threefry2x32
from .. import _cuda


def _slot_uniform(k1, k2, gid, row):
    """The gene-addressed uniform at (slot key, gene id, row)."""
    y1, y2 = threefry2x32(k1, k2, gid, row >> 1)
    return bits_to_open01(torch.where(row % 2 == 1, y2, y1))


def _variation_one(a_rows, b_rows, do_rows, table_low, table_high, table_is_mask,
                   table_mask_bits, table_ids, slot_keys, pm_gene):
    P, G = a_rows.shape
    half = P // 2
    dev = a_rows.device
    rows = torch.arange(P, dtype=torch.int64, device=dev)[:, None]
    gid = table_ids.to(torch.int64)[None, :]
    k = slot_keys.to(torch.int64)
    u_swap = _slot_uniform(k[0, 0], k[0, 1], gid, rows % half)
    swap = (do_rows.to(torch.int32)[:, None] > 0) & (u_swap < 0.5)
    child = torch.where(swap, b_rows, a_rows)
    u_do = _slot_uniform(k[1, 0], k[1, 1], gid, rows)
    u_val = _slot_uniform(k[2, 0], k[2, 1], gid, rows)
    bitpos = torch.floor(u_val * torch.clamp_min(table_mask_bits, 1)).to(torch.int32)
    flipped = torch.bitwise_xor(child, torch.bitwise_left_shift(
        torch.ones_like(bitpos), bitpos))
    lo, hi = table_low, table_high
    reset = torch.floor(lo.to(torch.float32) + u_val * (hi - lo).to(torch.float32)
                        ).to(torch.int32)
    mutated = torch.where(table_is_mask.to(torch.int32) > 0, flipped, reset)
    child = torch.where(u_do < pm_gene, mutated, child)
    return torch.minimum(torch.maximum(child, lo), hi - 1)


def pop_variation_plain(*args):
    """The kernel's plain PyTorch version (same arguments, lanes too)."""
    if args[0].dim() == 2:
        return _variation_one(*args)
    return torch.stack([_variation_one(*(a[i] for a in args))
                        for i in range(args[0].shape[0])])


def uint32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) → int32 tensor of the same bits (what the
    kernels read through a uint32_t pointer)."""
    w = words.to(torch.int64)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()


# the launchers' leading pointer arguments, in order
VARIATION_OPERANDS = ("a_rows", "b_rows", "do_rows", "low", "high", "is_mask",
                      "mask_bits", "ids", "keys", "pm")


def variation_operands(a_rows, b_rows, do_rows, table_low, table_high,
                       table_is_mask, table_mask_bits, table_ids, slot_keys,
                       pm_gene):
    """Checked, contiguous int32/float32 operands of the variation kernels
    with a leading lane axis (shared with ``pop_generation``) →
    (single, operands): a single problem's operands gain a lane axis of 1."""
    single = a_rows.dim() == 2
    if single:
        a_rows, b_rows, do_rows, table_low, table_high, table_is_mask, \
            table_mask_bits, table_ids, slot_keys, pm_gene = (
                t[None] for t in (a_rows, b_rows, do_rows, table_low, table_high,
                                  table_is_mask, table_mask_bits, table_ids, slot_keys,
                                  torch.as_tensor(pm_gene)))
    dev = a_rows.device
    L, P, G = a_rows.shape
    if P % 2:
        raise ValueError(f"variation needs an even population, got {P}")
    if P // 2 > 65535 or L > 65535:
        raise ValueError(f"population {P} x {L} lanes exceeds the kernel's grid "
                         "(2 * 65535 rows, 65535 lanes)")
    i32 = lambda t: t.to(device=dev, dtype=torch.int32).contiguous()
    ops = dict(a_rows=a_rows, b_rows=b_rows, do_rows=i32(do_rows),
               low=i32(table_low), high=i32(table_high),
               is_mask=i32(table_is_mask), mask_bits=i32(table_mask_bits),
               ids=i32(table_ids), keys=uint32_bits(slot_keys.to(dev)),
               pm=pm_gene.to(device=dev, dtype=torch.float32).reshape(-1).contiguous())
    for name, shape in (("a_rows", (L, P, G)), ("b_rows", (L, P, G)), ("do_rows", (L, P)),
                        ("low", (L, G)), ("high", (L, G)), ("is_mask", (L, G)),
                        ("mask_bits", (L, G)), ("ids", (L, G)), ("keys", (L, 3, 2))):
        _cuda.check(ops[name], name, torch.int32, shape, dev)
    _cuda.check(ops["pm"], "pm_gene", torch.float32, (L,), dev)
    return single, ops


def pop_variation_call(a_rows, b_rows, do_rows, table_low, table_high,
                       table_is_mask, table_mask_bits, table_ids, slot_keys,
                       pm_gene) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the children
    it writes (arguments as :func:`pop_variation_kernel`; P, G > 0)."""
    if a_rows.device.type != "cuda":
        raise ValueError(f"pop_variation_kernel launches on CUDA tensors, "
                         f"got {a_rows.device}")
    single, o = variation_operands(a_rows, b_rows, do_rows, table_low, table_high,
                                   table_is_mask, table_mask_bits, table_ids,
                                   slot_keys, pm_gene)
    L, P, G = o["a_rows"].shape
    children = torch.empty((L, P, G), dtype=torch.int32, device=a_rows.device)
    args = (*(o[k].data_ptr() for k in VARIATION_OPERANDS), L, P, G, children.data_ptr())
    return (_cuda.Launch("pop_variation_kernel", "pop_variation_launch", args,
                         (*o.values(), children)), children[0] if single else children)


def pop_variation_kernel(a_rows, b_rows, do_rows, table_low, table_high,
                         table_is_mask, table_mask_bits, table_ids, slot_keys,
                         pm_gene) -> torch.Tensor:
    """(P, G) int32 children from pre-gathered parent frames.

    a_rows/b_rows: (P, G) int32 no-swap / swap sources per child row.
    do_rows: (P,) bool/int32 per-child do-crossover gate.
    table_*: the GeneTable leaves, (G,) each.
    slot_keys: (3, 2) uint32 words (int64) — ``genome._slot_keys`` of the
        gene-draw key over the swap, mutation-gate and mutation-value slots.
    pm_gene: () float32 per-gene mutation probability.

    Lanes: every operand with a leading lane axis — parents (L, P, G),
    gates (L, P), tables (L, G), keys (L, 3, 2), pm_gene (L,) → (L, P, G)
    children in one launch (the lane is the grid's z axis).
    """
    if a_rows.device.type == "cpu":
        return pop_variation_plain(a_rows, b_rows, do_rows, table_low,
                                   table_high, table_is_mask, table_mask_bits,
                                   table_ids, slot_keys, pm_gene)
    launch, children = pop_variation_call(a_rows, b_rows, do_rows, table_low,
                                          table_high, table_is_mask,
                                          table_mask_bits, table_ids,
                                          slot_keys, pm_gene)
    if children.numel():
        launch()
    return children
