"""Chromosome encoding for the approximate printed MLP (paper Fig. 3).

PyTorch counterpart of ``repro.core.genome``. A chromosome is a flat
``int32`` vector: per layer the weight masks, signs and exponents, then the
biases, the bias shift and the output right shift. :class:`GenomeSpec` owns
the layout and the per-gene integer bounds (numpy, host side);
:class:`GeneTable` carries the per-gene operator metadata as tensors on the
run's device.

Gene-shaped randomness is counter based: uniform ``(i, j)`` of a draw
depends only on ``(key, slot, ids[j], i)``. The key is folded once per draw
slot, the Threefry-2x32 counter words are ``(ids[j], i >> 1)`` and the two
output words serve rows ``2r`` and ``2r + 1``. The CUDA kernels
(``repro_torch/csrc``) evaluate the same hash at the same counters.

uint32 arithmetic: torch's uint32 support is partial, so every hash here
runs in int64 tensors holding values in ``[0, 2**32)`` and masked back to
32 bits after each add and shift. Keys are (2,) int64 tensors of that kind.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MLPTopology:
    """(n_in, h_1, ..., n_out) with the paper's bitwidths."""

    sizes: tuple[int, ...]
    input_bits: int = 4      # paper: 4-bit inputs
    act_bits: int = 8        # paper: 8-bit QReLU outputs
    weight_bits: int = 8     # n in Eq. (1): k ∈ [0, n-1)
    bias_bits: int = 8       # low-bitwidth quantized biases

    @property
    def n_layers(self) -> int:
        return len(self.sizes) - 1

    @property
    def n_params(self) -> int:
        """Weight + bias count (the paper's 'Parameters' column, Table I)."""
        return sum(self.sizes[l] * self.sizes[l + 1] + self.sizes[l + 1]
                   for l in range(self.n_layers))

    def layer_in_bits(self, l: int) -> int:
        return self.input_bits if l == 0 else self.act_bits

    @property
    def max_exp(self) -> int:
        return self.weight_bits - 2  # k ∈ [0, n-1)  →  {0, ..., n-2}


@dataclasses.dataclass
class GeneTable:
    """Per-gene operator metadata, (G,) tensors on the run's device.

    ``ids`` addresses the PRNG (gene ``j`` draws at ``(key, slot, ids[j],
    row)``). Padding entries have bounds ``[0, 1)``, ``is_mask=False`` and
    ``valid=False``."""

    low: torch.Tensor        # (G,) int32 inclusive lower bound
    high: torch.Tensor       # (G,) int32 exclusive upper bound
    is_mask: torch.Tensor    # (G,) bool — bit-flip mutation instead of reset
    mask_bits: torch.Tensor  # (G,) int32 — bit width of mask genes (0 else)
    ids: torch.Tensor        # (G,) int32 PRNG draw ids
    valid: torch.Tensor      # (G,) bool — False on padding


# -- counter-based gene RNG -------------------------------------------------

SLOT_CROSS_SWAP = 0   # uniform crossover's per-gene swap draw
SLOT_MUT_DO = 1       # mutate: does gene (i, j) mutate at all?
SLOT_MUT_VAL = 2      # mutate: flipped-bit position (masks) / reset value
SLOT_INIT = 0         # random_population (separate key)
SLOT_DEVICE = 3       # device-variation draws (not in this port yet)

_THREEFRY_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values.

    All four operands broadcast; returns ``(y1, y2)`` of the broadcast
    shape, bit-identical to ``repro.core.genome.threefry2x32`` (and so to
    jax.random's Threefry). Every add and shift is masked back to 32 bits.
    """
    ks = (k1, k2, k1 ^ k2 ^ _THREEFRY_PARITY)
    v0 = (x1 + k1) & MASK32
    v1 = (x2 + k2) & MASK32
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            v0 = (v0 + v1) & MASK32
            v1 = ((v1 << r) & MASK32) | (v1 >> (32 - r))
            v1 = v0 ^ v1
        v0 = (v0 + ks[(d + 1) % 3]) & MASK32
        v1 = (v1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return v0, v1


def _slot_keys(key: torch.Tensor, slots) -> torch.Tensor:
    """Fold ``key`` once per draw slot → (len(slots), 2) int64 words."""
    s = torch.as_tensor(list(slots), dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], s, torch.zeros_like(s))
    return torch.stack([y1, y2], dim=-1)


def bits_to_open01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) → float32 in [0, 1): the 23-mantissa-bit bit
    cast jax.random.uniform uses."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def gene_uniform_slots(key, ids: torch.Tensor, n: int, slots) -> torch.Tensor:
    """(len(slots), n, G) float32 uniforms from one Threefry pass; element
    (s, i, j) is the gene-addressed draw ``(key, slots[s], ids[j], i)``."""
    slots = range(slots) if isinstance(slots, int) else slots
    ks = _slot_keys(key, list(slots))                        # (S, 2)
    half = (n + 1) // 2
    hi = ids.to(torch.int64)[None, None, :]                  # gene id word
    lo = torch.arange(half, dtype=torch.int64, device=ids.device)[None, :, None]
    y1, y2 = threefry2x32(ks[:, 0, None, None], ks[:, 1, None, None], hi, lo)
    w = torch.stack([y1, y2], dim=2)                         # (S, half, 2, G)
    bits = w.reshape(w.shape[0], 2 * half, -1)[:, :n]
    return bits_to_open01(bits)


def gene_uniform(key, ids: torch.Tensor, n: int, slot: int = 0) -> torch.Tensor:
    """(n, G) float32 uniforms addressed by (key, slot, ids[j], row)."""
    return gene_uniform_slots(key, ids, n, (slot,))[0]


def random_population(key, genes: GeneTable, n: int) -> torch.Tensor:
    """Uniform random (n, G) int32 population within the table's bounds.

    ``floor(lo + u * (hi - lo))`` runs as two separately rounded float32
    ops; at this repo's gene ranges that equals the reference's XLA result
    for every possible ``u`` (tests/test_torch_prng.py sweeps all 2**23)."""
    u = gene_uniform(key, genes.ids, n, slot=SLOT_INIT)
    lo = genes.low.to(torch.float32)
    hi = genes.high.to(torch.float32)
    return torch.floor(lo + u * (hi - lo)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LayerSlices:
    """Index ranges of each gene family inside the flat chromosome."""

    masks: slice     # fan_in * fan_out genes
    signs: slice
    exps: slice
    biases: slice    # fan_out genes
    bshift: slice    # 1 gene
    rshift: slice    # 1 gene
    fan_in: int
    fan_out: int
    in_bits: int


class GenomeSpec:
    """Flat-vector layout + integer bounds for a topology's chromosome.

    The bounds and masks are numpy arrays; :meth:`table` puts them on a
    device as a :class:`GeneTable`."""

    def __init__(self, topo: MLPTopology):
        self.topo = topo
        self.layers: list[LayerSlices] = []
        low: list[np.ndarray] = []
        high: list[np.ndarray] = []
        off = 0

        for l in range(topo.n_layers):
            fi, fo = topo.sizes[l], topo.sizes[l + 1]
            ib = topo.layer_in_bits(l)
            nw = fi * fo

            def seg(n: int, lo: int, hi: int):
                nonlocal off
                s = slice(off, off + n)
                low.append(np.full(n, lo, np.int32))
                high.append(np.full(n, hi, np.int32))
                off += n
                return s

            masks = seg(nw, 0, 2**ib)
            signs = seg(nw, 0, 2)
            exps = seg(nw, 0, topo.max_exp + 1)
            biases = seg(fo, -(2 ** (topo.bias_bits - 1)), 2 ** (topo.bias_bits - 1))
            bshift = seg(1, 0, topo.max_exp + 1)
            rshift = seg(1, 0, 8)
            self.layers.append(
                LayerSlices(masks, signs, exps, biases, bshift, rshift, fi, fo, ib))

        self.n_genes = off
        self.low = np.concatenate(low)
        self.high = np.concatenate(high)
        self.is_mask = np.zeros(off, bool)
        self.mask_bits = np.zeros(off, np.int32)
        self.is_exp = np.zeros(off, bool)
        for sl in self.layers:
            self.is_mask[sl.masks] = True
            self.mask_bits[sl.masks] = sl.in_bits
            self.is_exp[sl.exps] = True
        self.gene_ids = np.arange(off, dtype=np.int32)
        self.gene_valid = np.ones(off, bool)

    def table(self, device="cpu") -> GeneTable:
        """The spec's own GeneTable (identity layout) on ``device``."""
        t = lambda a: torch.as_tensor(a, device=device)
        return GeneTable(t(self.low), t(self.high), t(self.is_mask),
                         t(self.mask_bits), t(self.gene_ids), t(self.gene_valid))

    # -- structured views -------------------------------------------------
    def layer_params(self, genome: torch.Tensor, l: int):
        """Return (masks[fi,fo], signs[fi,fo], exps[fi,fo], bias[fo], bshift,
        rshift) for a genome (1-D) or a population (…, n_genes)."""
        sl = self.layers[l]
        lead = genome.shape[:-1]

        def take(s: slice, shape):
            return genome[..., s].reshape(lead + shape)

        masks = take(sl.masks, (sl.fan_in, sl.fan_out))
        signs = take(sl.signs, (sl.fan_in, sl.fan_out)) * 2 - 1   # {0,1} → {-1,+1}
        exps = take(sl.exps, (sl.fan_in, sl.fan_out))
        bias = take(sl.biases, (sl.fan_out,))
        bshift = genome[..., sl.bshift.start]
        rshift = genome[..., sl.rshift.start]
        return masks, signs, exps, bias, bshift, rshift

    def exact_seed(self, weights: Sequence[np.ndarray],
                   biases: Sequence[np.ndarray]) -> np.ndarray:
        """Encode float weights as a 'nearly non-approximate' chromosome
        (paper §IV-A doping); numpy, identical to the reference."""
        topo = self.topo
        g = np.zeros(self.n_genes, np.int32)
        for l, sl in enumerate(self.layers):
            w = np.asarray(weights[l], np.float64)        # (fan_in, fan_out)
            b = np.asarray(biases[l], np.float64)         # (fan_out,)
            absw = np.abs(w[w != 0])
            med = np.median(absw) if absw.size else 1.0
            # target: median |w| → exponent 2 (leaves headroom both ways)
            scale = (2.0**2) / max(med, 1e-12)
            k = np.clip(np.round(np.log2(np.maximum(np.abs(w) * scale, 1e-12))),
                        0, topo.max_exp).astype(np.int32)
            s = (w >= 0).astype(np.int32)
            m = np.full(w.shape, 2**sl.in_bits - 1, np.int32)   # keep all bits
            bq = np.clip(np.round(b * scale * (2**sl.in_bits - 1)),
                         -(2 ** (topo.bias_bits - 1)),
                         2 ** (topo.bias_bits - 1) - 1).astype(np.int32)
            g[sl.masks] = m.reshape(-1)
            g[sl.signs] = s.reshape(-1)
            g[sl.exps] = k.reshape(-1)
            g[sl.biases] = bq
            g[sl.bshift.start] = 0
            # QReLU rescale ≈ log2(scale * input_range) to undo the blow-up
            g[sl.rshift.start] = int(np.clip(np.round(np.log2(scale * 15)), 0, 7))
        return g
