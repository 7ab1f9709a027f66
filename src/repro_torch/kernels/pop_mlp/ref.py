"""Plain PyTorch population fitness.

``pop_mlp_correct_ref``   — the untiled oracle (materializes
                            (pop, samples, fan_in, fan_out) intermediates).
``pop_mlp_correct_tiled`` — the tiled path: population and sample tiles keep
                            intermediates small, and the dedup/suite bounds
                            cut the work. It is also the plain version of the
                            CUDA kernel ``pop_mlp_correct``.
``pop_mlp_correct_mc``    — the same tiling over K device instances → (P, K);
                            the plain version of ``pop_mlp_correct_mc``'s
                            CUDA kernel.
``pop_mlp_correct_mc_tables`` — the same counts by the arithmetic of the
                            table kernels (K4, K1 at one instance with no
                            deltas, both branches of K3 on their children):
                            per-(chromosome, instance) signed multipliers,
                            shifted biases and right shifts in their padded
                            table layout (``mc_tables``, ``mc_layout``), and
                            the kernels' shared memory (``mc_smem_bytes``,
                            ``k1_smem_bytes``, ``generation_smem_bytes``,
                            ``generation_mc_smem_bytes``).
"""
from __future__ import annotations

import dataclasses

import torch

from ...core.genome import GenomeSpec
from ...core.mlp import (population_accuracy, population_correct_counts,
                         population_correct_counts_mc)


def pop_mlp_correct_ref(pop, x_int, labels, *, spec: GenomeSpec,
                        out_mask=None):
    acc = population_accuracy(spec, pop, x_int, labels, out_mask=out_mask)
    return torch.round(acc * labels.shape[0]).to(torch.int32)


def _bound(v, n: int) -> int:
    """A row/sample bound as a host int clamped to [0, n] (reads a device
    scalar back: the plain path may synchronise, the kernel never does)."""
    return n if v is None else max(0, min(n, int(v)))


def pop_mlp_correct_tiled(pop, x_int, labels, *, spec: GenomeSpec,
                          pop_tile: int = 64, sample_tile: int = 256,
                          n_valid_rows=None, n_valid_samples=None,
                          out_mask=None):
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts, tiled.

    Rows at or past ``n_valid_rows`` are not evaluated and count 0 (the
    reference leaves them unspecified; callers overwrite them). Samples at
    or past ``n_valid_samples`` are not counted; the reference skips whole
    sample tiles past it, which gives the same counts whenever those
    samples are padding (label −1), the only way the engine sets it.
    ``out_mask`` pins invalid output columns (``core.mlp.mask_logits``).
    """
    count = lambda rows, x, y: population_correct_counts(spec, rows, x, y,
                                                         out_mask=out_mask)
    return _tiled(count, (), pop, x_int, labels, pop_tile, sample_tile,
                  n_valid_rows, n_valid_samples)


def pop_mlp_correct_mc(pop, x_int, labels, *, spec: GenomeSpec, dev,
                       gene_high, pop_tile: int = 64, sample_tile: int = 256,
                       n_valid_rows=None, n_valid_samples=None,
                       out_mask=None):
    """(P, G) × (K, G) deltas → (P, K) int32 correct counts, tiled as
    :func:`pop_mlp_correct_tiled`. ``n_valid_rows`` counts chromosomes: a
    row past it is not evaluated on any instance (all K columns 0). Column
    k equals the nominal count of ``apply_device_deltas(pop, dev[k],
    gene_high)``; ``dev``'s row 0 is all zero, so column 0 is nominal."""
    count = lambda rows, x, y: population_correct_counts_mc(
        spec, rows, dev, gene_high, x, y, out_mask=out_mask)
    return _tiled(count, (dev.shape[0],), pop, x_int, labels, pop_tile,
                  sample_tile, n_valid_rows, n_valid_samples)


def _tiled(count, val_shape, pop, x_int, labels, pop_tile, sample_tile,
           n_valid_rows, n_valid_samples):
    """Sum ``count(rows, x, y)`` over population and sample tiles inside
    the row and sample bounds into a zeroed (P,) + val_shape tensor."""
    P = pop.shape[0]
    n_rows = _bound(n_valid_rows, P)
    n_samp = _bound(n_valid_samples, labels.shape[0])
    counts = torch.zeros((P,) + val_shape, dtype=torch.int32, device=pop.device)
    for p0 in range(0, n_rows, pop_tile):
        rows = pop[p0:min(p0 + pop_tile, n_rows)]
        for s0 in range(0, n_samp, sample_tile):
            s1 = min(s0 + sample_tile, n_samp)
            counts[p0:p0 + rows.shape[0]] += count(rows, x_int[s0:s1], labels[s0:s1])
    return counts


# -- the table kernels' arithmetic (csrc/common.cuh McTables) on the CPU ---------

# csrc/common.cuh kK4*, kK1*, kK3* (K3's n_dev branch), kK3N* (its nominal
# branch): each table kernel's (chromosomes per block, samples per thread,
# blocks per SM)
MC_TILES = {"K4": (3, 1, 4), "K1": (3, 4, 4), "K3": (2, 4, 4), "K3N": (2, 8, 4)}
MAX_LAYERS = 4     # csrc/common.cuh kMaxLayers
MAX_WIDTH = 32     # csrc/common.cuh kMaxWidth
# the (input, hidden, output) widths the table kernels have forwards compiled
# for (csrc/common.cuh kMcBuckets): pendigits' and the padded suite's; the
# paper's other datasets pad into them
MC_BUCKETS = ((16, 5, 10), (21, 5, 10))
H100_SMEM_OPTIN = 232448   # bytes of shared memory an H100 grants a block
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class McLayout:
    """Where a chromosome's weights and neurons sit in K4's tables
    (``csrc/common.cuh`` ``McLayout``), laid out for the widths ``fi[l]``
    → ``fo[l]`` of each layer: layer l's weight (i, j) at word ``woff[l] +
    i fo[l] + j`` of a (chromosome, instance) multiplier block and of a
    mask block (``wp`` words each); its neuron j at word ``noff[l] + j`` of
    a bias block (``np`` words)."""

    woff: tuple
    noff: tuple
    fi: tuple
    fo: tuple
    wp: int
    np: int


def mc_bucket(sizes):
    """The compiled widths with the fewest weights that hold the 2-layer
    net ``sizes``, or None (the general kernel's nets)."""
    fits = [b for b in MC_BUCKETS
            if len(sizes) == 3 and all(w <= c for w, c in zip(sizes, b))]
    return min(fits, key=lambda b: b[0] * b[1] + b[1] * b[2], default=None)


def mc_layout(sizes, packed: bool = False) -> McLayout:
    """The tables' layout of the net ``sizes``: laid out for the widths of
    :func:`mc_bucket`, each layer padded to 4 words, or for the net's own
    widths packed (``packed``, or no compiled widths hold the net)."""
    bucket = None if packed else mc_bucket(sizes)
    widths, pad = (sizes, 1) if bucket is None else (bucket, 4)
    up = lambda n: -(-n // pad) * pad
    woff, noff, wp, np_ = [], [], 0, 0
    for fi, fo in zip(widths[:-1], widths[1:]):
        woff.append(wp)
        noff.append(np_)
        wp += up(fi * fo)
        np_ += up(fo)
    return McLayout(tuple(woff), tuple(noff), tuple(widths[:-1]), tuple(widths[1:]), wp, np_)


def _smem_bytes(m: McLayout, n_dev: int, rows: int, extra: int) -> int:
    return 4 * (extra + rows * (n_dev * m.wp + m.wp + m.np + MAX_LAYERS + n_dev) + MAX_WIDTH)


def mc_smem_bytes(sizes, n_dev: int, limit: int = H100_SMEM_OPTIN, *,
                  rows: int = MC_TILES["K4"][0], extra: int = 0) -> int:
    """A table kernel's dynamic shared memory per block on a card that
    grants a block ``limit`` bytes (``csrc/common.cuh`` ``mc_plan`` and
    ``mc_smem_words``): ``extra`` words ahead of the tables, then per
    chromosome (``rows`` of them; K4's by default) the n_dev multiplier
    blocks, the masks, the biases, the right shifts and the n_dev counts,
    then the output mask, in the compiled widths' layout if it fits
    ``limit``, else packed (the general kernel's)."""
    padded = _smem_bytes(mc_layout(sizes), n_dev, rows, extra)
    if padded <= limit:
        return padded
    return _smem_bytes(mc_layout(sizes, packed=True), n_dev, rows, extra)


def k1_smem_bytes(sizes, limit: int = H100_SMEM_OPTIN) -> int:
    """K1's dynamic shared memory per block (``csrc/pop_mlp.cu``
    ``pop_mlp_correct_smem_bytes``): the tables of its tile at one
    instance."""
    return mc_smem_bytes(sizes, 1, limit, rows=MC_TILES["K1"][0])


def _generation_smem_bytes(tile: str, sizes, n_genes: int, n_dev: int, limit: int) -> int:
    rows = MC_TILES[tile][0]
    children = -(-rows * n_genes // 4) * 4
    return mc_smem_bytes(sizes, n_dev, limit, rows=rows, extra=children)


def generation_smem_bytes(sizes, n_genes: int, limit: int = H100_SMEM_OPTIN) -> int:
    """K3's nominal branch's dynamic shared memory per block
    (``csrc/pop_generation.cu`` ``pop_generation_smem_bytes``): its
    children's tile (rows × ``n_genes`` words, rounded up to a multiple of
    4), then the tables of those rows at one instance."""
    return _generation_smem_bytes("K3N", sizes, n_genes, 1, limit)


def generation_mc_smem_bytes(sizes, n_genes: int, n_dev: int,
                             limit: int = H100_SMEM_OPTIN) -> int:
    """K3's ``n_dev`` branch's (``pop_generation_mc_smem_bytes``): the
    same layout for its own tile, with the tables at n_dev instances."""
    return _generation_smem_bytes("K3", sizes, n_genes, n_dev, limit)


def mc_tables(pop, dev, gene_high, *, spec: GenomeSpec, packed: bool = False):
    """The table kernels' tables of each chromosome in the layout
    :func:`mc_layout`, as ``csrc/common.cuh`` ``mc_build`` fills them (int64
    tensors holding uint32 words; slots past the net's widths and padding
    0): ``mult`` (P, K, wp), instance k's multiplier of each weight, ``(2
    sign - 1) << e_k`` mod 2^32 with ``e_k`` the exponent gene moved by
    ``dev[k]`` and clipped into [0, gene_high - 1] (a zero delta leaves it
    as it is), and 0 where ``e_k`` leaves [0, 31]; ``mask`` (P, wp);
    ``bias`` (P, np), each neuron's bias shifted left by its layer's bias
    shift (0 outside [0, 31]); ``rsh`` (P, n_layers), each layer's right
    shift, 31 where it leaves [0, 31]. ``dev`` None: the nominal device's
    tables (K1's), one instance with ``e_k = e``; ``gene_high`` is not
    read."""
    topo = spec.topo
    m = mc_layout(topo.sizes, packed)
    P, K = pop.shape[0], 1 if dev is None else dev.shape[0]
    g = pop.to(torch.int64)
    mult = torch.zeros((P, K, m.wp), dtype=torch.int64)
    mask = torch.zeros((P, m.wp), dtype=torch.int64)
    bias = torch.zeros((P, m.np), dtype=torch.int64)
    rsh = torch.zeros((P, topo.n_layers), dtype=torch.int64)
    for l, sl in enumerate(spec.layers):
        fi, fo, n = sl.fan_in, sl.fan_out, m.fi[l] * m.fo[l]
        ek = e = g[:, None, sl.exps]                               # (P, 1, fi fo)
        if dev is not None:
            de = dev.to(torch.int64)[None, :, sl.exps]             # (1, K, fi fo)
            hi = gene_high.to(torch.int64)[sl.exps]
            ek = torch.where(de == 0, e, torch.minimum(torch.clamp(e + de, min=0), hi - 1))
        sign = (g[:, None, sl.signs] * 2 - 1) & _U32
        w = torch.where((ek < 0) | (ek > 31), 0, (sign << ek.clamp(0, 31)) & _U32)
        slots = torch.zeros((P, K, m.fi[l], m.fo[l]), dtype=torch.int64)
        slots[:, :, :fi, :fo] = w.reshape(P, K, fi, fo)
        mult[:, :, m.woff[l]:m.woff[l] + n] = slots.flatten(2)
        slots = torch.zeros((P, m.fi[l], m.fo[l]), dtype=torch.int64)
        slots[:, :fi, :fo] = (g[:, sl.masks] & _U32).view(P, fi, fo)
        mask[:, m.woff[l]:m.woff[l] + n] = slots.flatten(1)
        bsh = g[:, sl.bshift.start, None]
        b = ((g[:, sl.biases] & _U32) << bsh.clamp(0, 31)) & _U32
        bias[:, m.noff[l]:m.noff[l] + fo] = torch.where((bsh < 0) | (bsh > 31), 0, b)
        rs = g[:, sl.rshift.start]
        rsh[:, l] = torch.where((rs < 0) | (rs > 31), 31, rs)
    return mult, mask, bias, rsh


def _mul32(a, b):
    """a * b mod 2^32 for int64 tensors holding uint32 values (in 16-bit
    halves of b, so nothing overflows int64)."""
    return ((((a * (b >> 16)) & 0xFFFF) << 16) + a * (b & 0xFFFF)) & _U32


def pop_mlp_correct_mc_tables(pop, x_int, labels, *, spec: GenomeSpec, dev=None,
                              gene_high=None, n_valid_rows=None, n_valid_samples=None,
                              out_mask=None, packed: bool = False):
    """(P, G) × (K, G) deltas → (P, K) int32 correct counts, computed as
    the table kernels compute them (``dev`` None: K1's (P, 1) nominal
    counts, one instance with no deltas): each weight of instance k is one
    wrapping multiply-add ``acc += (h & mask) * mult[k]`` read through the
    tables of :func:`mc_tables` over the widths of their layout (inputs
    past the net's read as 0, output columns past it masked), each accumulator
    starts at the neuron's shifted bias, a hidden layer's QReLU is an
    arithmetic shift by the table's right shift clamped into [0, act_max],
    and layer 1's ``x & mask`` is formed once and shared by the instances.
    Bounds and ``out_mask`` as :func:`pop_mlp_correct_mc`."""
    topo = spec.topo
    m = mc_layout(topo.sizes, packed)
    mult, mask, bias, rsh = mc_tables(pop, dev, gene_high, spec=spec, packed=packed)
    P, K = mult.shape[:2]
    n_rows = _bound(n_valid_rows, P)
    n_samp = _bound(n_valid_samples, labels.shape[0])
    x = torch.zeros((n_samp, m.fi[0]), dtype=torch.int64)
    x[:, :topo.sizes[0]] = x_int[:n_samp].to(torch.int64) & _U32
    y = labels[:n_samp]
    om = torch.zeros(m.fo[-1], dtype=torch.int64)
    om[:topo.sizes[-1]] = 1 if out_mask is None else out_mask.to(torch.int64)
    counts = torch.zeros((P, K), dtype=torch.int32)
    act_max = 2**topo.act_bits - 1
    for p in range(n_rows):
        h = None
        for l in range(topo.n_layers):
            fi, fo = m.fi[l], m.fo[l]
            w = slice(m.woff[l], m.woff[l] + fi * fo)
            mk = mask[p, w].view(fi, fo)
            mu = mult[p, :, w].view(K, fi, fo)
            if l == 0:
                a = (x[:, :, None] & mk)[None]                     # (1, S, fi, fo): once
            else:
                a = h[:, :, :, None] & mk                          # (K, S, fi, fo)
            acc = bias[p, m.noff[l]:m.noff[l] + fo]
            for i in range(fi):
                acc = (acc + _mul32(a[:, :, i], mu[:, None, i])) & _U32
            v = acc - ((acc >> 31) << 32)                          # the int32 value
            if l < topo.n_layers - 1:
                v = torch.clamp(v >> rsh[p, l], 0, act_max)
            h = v                                                  # (K, S, fo)
        logits = torch.where(om > 0, h, torch.iinfo(torch.int32).min)
        pred = torch.argmax(logits, dim=-1)                        # the first maximum
        counts[p] = (pred == y[None]).sum(dim=-1, dtype=torch.int32)
    return counts
