"""Wrappers of the CUDA kernels ``pop_mlp_correct`` and
``pop_mlp_correct_mc`` (``csrc/pop_mlp.cu``).

``pop_mlp_correct`` replaces the Pallas TPU kernel ``repro/kernels/pop_mlp/
kernel.py:pop_mlp_correct``: (P, G) int32 genomes × (S, n_in) int32 samples
× (S,) int32 labels → (P,) int32 correct counts of the integer approximate
MLP. ``pop_mlp_correct_mc`` replaces ``pop_mlp_correct_mc`` there: the same
over K device instances given by a (K, G) delta table → (P, K) counts.
One kernel template runs both, from tables of per-instance weight
multipliers that each block builds in shared memory (K1 is one instance
with no deltas; ``ref.pop_mlp_correct_mc_tables`` is their arithmetic on
the CPU; the launchers' ``pop_mlp_correct_smem_bytes`` and
``pop_mlp_correct_mc_smem_bytes`` give their size, which the wrappers
check). The source's header says what bounds them on the card and how they
are laid out.

Both take a leading lane axis on every operand: L independent problems of
one layout scored in one launch, the lane on the grid's z axis (a single
problem is the case L = 1).

On a CUDA tensor a wrapper checks its inputs and launches its kernel on
the current stream; on a CPU tensor it runs the plain version
(``ref.pop_mlp_correct_tiled``, ``ref.pop_mlp_correct_mc``, per lane). It
never falls back from one to the other.
"""
from __future__ import annotations

import torch

from ...core.genome import GenomeSpec
from .. import _cuda
from .ref import MAX_LAYERS, MAX_WIDTH
from .ref import pop_mlp_correct_mc as pop_mlp_correct_mc_tiled
from .ref import pop_mlp_correct_tiled


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


def out_mask_or_ones(out_mask, shape: tuple, device) -> torch.Tensor:
    if out_mask is None:
        return torch.ones(shape, dtype=torch.int32, device=device)
    return out_mask.to(device=device, dtype=torch.int32).contiguous()


def _lane_plain(fn, pop, x_int, labels, n_valid_samples, out_mask, **kw):
    """``fn`` per lane of lane-axis operands, stacked (a single problem's
    operands go straight through)."""
    if pop.dim() == 2:
        return fn(pop, x_int, labels, n_valid_samples=n_valid_samples,
                  out_mask=out_mask, **kw)
    lane = _cuda.lane_item
    return torch.stack([fn(pop[i], x_int[i], labels[i],
                           n_valid_samples=lane(n_valid_samples, i),
                           out_mask=lane(out_mask, i),
                           **{k: lane(v, i) for k, v in kw.items()})
                        for i in range(pop.shape[0])])


def pop_mlp_correct_plain(pop, x_int, labels, *, spec: GenomeSpec, n_valid_rows=None,
                          n_valid_samples=None, out_mask=None):
    """The kernel's plain PyTorch version (``ref.pop_mlp_correct_tiled``,
    per lane): same counts, rows past n_valid_rows 0, samples past
    n_valid_samples not counted."""
    return _lane_plain(pop_mlp_correct_tiled, pop, x_int, labels, n_valid_samples,
                       out_mask, spec=spec, n_valid_rows=n_valid_rows)


def pop_mlp_correct_mc_plain(pop, x_int, labels, *, spec: GenomeSpec, dev, gene_high,
                             n_valid_rows=None, n_valid_samples=None, out_mask=None):
    """``pop_mlp_correct_mc``'s plain PyTorch version (per lane)."""
    return _lane_plain(pop_mlp_correct_mc_tiled, pop, x_int, labels, n_valid_samples,
                       out_mask, spec=spec, dev=dev, gene_high=gene_high,
                       n_valid_rows=n_valid_rows)


def as_lanes(pop, x_int, labels, out_mask, dev=None, gene_high=None):
    """A single problem's operands with a leading lane axis of 1 (views);
    lane-axis operands as they are. → (single, pop, x_int, labels,
    out_mask, dev, gene_high)"""
    if pop.dim() == 3:
        return False, pop, x_int, labels, out_mask, dev, gene_high
    one = lambda t: None if t is None else t[None]
    return (True, pop[None], x_int[None], labels[None], one(out_mask), one(dev),
            one(gene_high))


def pop_mlp_correct_call(pop, x_int, labels, *, spec: GenomeSpec,
                         n_valid_rows=None, n_valid_samples=None,
                         out_mask=None, dev=None, gene_high=None
                         ) -> tuple[_cuda.Launch, torch.Tensor]:
    """The checked launch of the kernel on CUDA tensors, and the zeroed
    counts it adds into (arguments as :func:`pop_mlp_correct`; P > 0).
    With ``dev`` and ``gene_high`` it is ``pop_mlp_correct_mc``'s launch
    and the counts are (P, K), or (L, P, K) over lanes."""
    device = pop.device
    if device.type != "cuda":
        raise ValueError(f"pop_mlp_correct launches on CUDA tensors, got {device}")
    single, pop, x_int, labels, out_mask, dev, gene_high = as_lanes(
        pop, x_int, labels, out_mask, dev, gene_high)
    L, P, G = pop.shape
    S, n_in = x_int.shape[1:]
    n_out = spec.topo.sizes[-1]
    if G != spec.n_genes or n_in != spec.topo.sizes[0]:
        raise ValueError(f"shapes pop {tuple(pop.shape)} / x {tuple(x_int.shape)} "
                         f"do not fit topology {spec.topo.sizes}")
    desc = _cuda.host_ints(net_desc(spec))
    _cuda.check(pop, "pop", torch.int32, (L, P, G), device)
    _cuda.check(x_int, "x_int", torch.int32, (L, S, n_in), device)
    _cuda.check(labels, "labels", torch.int32, (L, S), device)
    om = out_mask_or_ones(out_mask, (L, n_out), device)
    _cuda.check(om, "out_mask", torch.int32, (L, n_out), device)
    rows = _cuda.device_scalar(n_valid_rows, P, device)
    samp = _cuda.lane_bounds(n_valid_samples, S, L, device)
    head = (pop.data_ptr(), L, P, G, x_int.data_ptr(), labels.data_ptr(), S, n_in,
            rows.data_ptr(), samp.data_ptr(), om.data_ptr())
    keep = (pop, x_int, labels, rows, samp, om, desc)
    lib = _cuda.library()
    if dev is None:
        _cuda.check_smem(lib.pop_mlp_correct_smem_bytes(desc), device,
                         f"pop_mlp_correct at {spec.topo.sizes}")
        counts = torch.zeros((L, P), dtype=torch.int32, device=device)
        launch = _cuda.Launch("pop_mlp_correct", "pop_mlp_correct_launch",
                              (*head, desc, counts.data_ptr()), (*keep, counts))
    else:
        d, hi = check_deltas(dev, gene_high, L, G, device,
                             lambda K: lib.pop_mlp_correct_mc_smem_bytes(desc, K))
        counts = torch.zeros((L, P, d.shape[1]), dtype=torch.int32, device=device)
        launch = _cuda.Launch("pop_mlp_correct_mc", "pop_mlp_correct_mc_launch",
                              (*head, d.data_ptr(), hi.data_ptr(), d.shape[1], desc,
                               counts.data_ptr()), (*keep, d, hi, counts))
    return launch, counts[0] if single else counts


def pop_mlp_correct(pop, x_int, labels, *, spec: GenomeSpec,
                    n_valid_rows=None, n_valid_samples=None,
                    out_mask=None) -> torch.Tensor:
    """(P, G) × (S, n_in) × (S,) → (P,) int32 correct counts.

    ``n_valid_rows``/``n_valid_samples``: optional bounds (ints or ()
    int32 tensors on the device — the kernel reads them there, so a bound
    computed on the card costs no synchronisation). Rows at or past
    ``n_valid_rows`` come back 0; samples at or past ``n_valid_samples``
    are not counted. ``out_mask`` ((n_out,)): zero marks an invalid
    output column. Labels of −1 never match.

    Lanes: pop (L, P, G), x_int (L, S, n_in), labels (L, S), out_mask
    (L, n_out) and n_valid_samples () or (L,) → (L, P) counts in one
    launch (the lane is the grid's z axis); ``n_valid_rows`` bounds every
    lane."""
    if pop.device.type == "cpu":
        return pop_mlp_correct_plain(pop, x_int, labels, spec=spec,
                                     n_valid_rows=n_valid_rows,
                                     n_valid_samples=n_valid_samples,
                                     out_mask=out_mask)
    launch, counts = pop_mlp_correct_call(pop, x_int, labels, spec=spec,
                                          n_valid_rows=n_valid_rows,
                                          n_valid_samples=n_valid_samples,
                                          out_mask=out_mask)
    if pop.shape[-2]:
        launch()
    return counts


def check_deltas(dev, gene_high, L: int, G: int, device,
                 smem_bytes) -> tuple[torch.Tensor, torch.Tensor]:
    """The (L, K, G) delta tables and the (L, G) gene bounds as contiguous
    int32 tensors on ``device`` (K >= 1), checked; ``smem_bytes(K)``, the
    kernel's shared memory per block at K instances, must fit the card."""
    if dev.dim() != 3 or dev.shape[1] < 1:
        raise ValueError(f"dev must be an (L, K, G) delta table with K >= 1, got "
                         f"shape {tuple(dev.shape)}")
    if gene_high is None:
        raise ValueError("dev needs gene_high (per-gene exclusive upper bounds)")
    d = dev.to(dtype=torch.int32).contiguous()
    hi = gene_high.to(dtype=torch.int32).contiguous()
    _cuda.check(d, "dev", torch.int32, (L, dev.shape[1], G), device)
    _cuda.check(hi, "gene_high", torch.int32, (L, G), device)
    _cuda.check_smem(smem_bytes(d.shape[1]), device,
                     f"a device-instance kernel at G={G}, K={d.shape[1]}")
    return d, hi


def pop_mlp_correct_mc(pop, x_int, labels, dev, gene_high, *,
                       spec: GenomeSpec, n_valid_rows=None,
                       n_valid_samples=None, out_mask=None) -> torch.Tensor:
    """(P, G) × (S, n_in) × (S,) × (K, G) deltas × (G,) bounds → (P, K)
    int32 correct counts: column k scores each genome with its exponent
    genes moved by ``dev[k]`` and clipped into ``[0, gene_high - 1]``.
    The deltas must be zero off the exponent genes, as
    ``engine.device_deltas`` makes them. Bounds and ``out_mask`` as
    :func:`pop_mlp_correct`; a row past ``n_valid_rows`` is 0 in every
    column. Lanes as :func:`pop_mlp_correct`, with dev (L, K, G) and
    gene_high (L, G) → (L, P, K)."""
    if pop.device.type == "cpu":
        return pop_mlp_correct_mc_plain(pop, x_int, labels, spec=spec, dev=dev,
                                        gene_high=gene_high,
                                        n_valid_rows=n_valid_rows,
                                        n_valid_samples=n_valid_samples,
                                        out_mask=out_mask)
    launch, counts = pop_mlp_correct_call(pop, x_int, labels, spec=spec,
                                          n_valid_rows=n_valid_rows,
                                          n_valid_samples=n_valid_samples,
                                          out_mask=out_mask, dev=dev,
                                          gene_high=gene_high)
    if pop.shape[-2]:
        launch()
    return counts
