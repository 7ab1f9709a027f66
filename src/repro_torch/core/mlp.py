"""Integer forward pass of the approximate printed MLP — paper Eq. (4):

    y_j = QReLU( Σ_i s_ij · ((m_ij ⊙ x_i) ≪ k_ij) + b_j )

PyTorch counterpart of ``repro.core.mlp``. All arithmetic is int32 and
wraps like XLA's: sums take ``dtype=torch.int32`` (torch would widen them
to int64), and torch's shifts give 0 (left) or the sign fill (right) for
amounts outside [0, 31], as XLA's do. Argmax returns the first maximum.

:func:`accuracy` scores one chromosome through the population fitness
dispatcher (the CUDA kernel ``pop_mlp_correct`` on a card);
:func:`fixed_point_forward` is the exact bespoke baseline's integer
inference (8-bit fixed-point weights, Table I).
"""
from __future__ import annotations

import torch

from .genome import GenomeSpec, apply_device_deltas
from .quantize import qrelu, quantize_inputs

INT32_MIN = -2**31


def _layer_forward(x, masks, signs, exps, bias, bshift, rshift, out_bits: int,
                   is_last: bool):
    """x: (..., fan_in) int32 → (..., fan_out) int32; the gene tensors
    broadcast against x's leading axes."""
    masked = torch.bitwise_and(x[..., :, None], masks)
    shifted = torch.bitwise_left_shift(masked, exps)
    acc = ((signs * shifted).sum(dim=-2, dtype=torch.int32)
           + torch.bitwise_left_shift(bias, bshift))
    if is_last:
        return acc
    return qrelu(acc, rshift, out_bits)


def mask_logits(logits: torch.Tensor, out_mask) -> torch.Tensor:
    """Pin invalid output columns (``out_mask == 0``) to INT32_MIN before
    argmax; ``None`` is a no-op."""
    if out_mask is None:
        return logits
    return torch.where(out_mask > 0, logits,
                       torch.tensor(INT32_MIN, dtype=logits.dtype,
                                    device=logits.device))


def _sample_axis_params(spec: GenomeSpec, genome: torch.Tensor, l: int):
    """Layer ``l``'s gene tensors of a genome (…, G), shaped to broadcast
    against activations (…, S, fan_in): a sample axis sits between the
    leading axes and the gene axes."""
    lead = genome.shape[:-1]
    masks, signs, exps, bias, bshift, rshift = spec.layer_params(genome, l)
    ins = lambda t: t.reshape(lead + (1,) + t.shape[len(lead):])
    return (ins(masks), ins(signs), ins(exps), ins(bias),
            bshift.reshape(lead + (1, 1)), rshift.reshape(lead + (1, 1)))


def mlp_forward(spec: GenomeSpec, genome: torch.Tensor,
                x_int: torch.Tensor) -> torch.Tensor:
    """Forward of a genome (G,) or a population (P, G) over x_int
    (S, n_in) → (S, n_out) or (P, S, n_out) int32 logits."""
    h = x_int.expand(genome.shape[:-1] + x_int.shape)
    n = spec.topo.n_layers
    for l in range(n):
        h = _layer_forward(h, *_sample_axis_params(spec, genome, l),
                           spec.topo.act_bits, is_last=(l == n - 1))
    return h


def count_mean(counts: torch.Tensor, n: int) -> torch.Tensor:
    """float32 mean of a 0/1 vector of length ``n`` from its int count.

    The reference's ``jnp.mean`` of a float32 0/1 vector compiles, eagerly
    and under jit, to the exact sum times float32 ``1/n``, rounded once;
    ``float32(count) / float32(n)`` differs in the last place for some
    counts (tests/test_torch_baselines.py sweeps every count)."""
    inv = torch.tensor(1.0 / n, dtype=torch.float32, device=counts.device)
    return counts.to(torch.float32) * inv


def mlp_predict(spec: GenomeSpec, genome: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """Float [0,1] features (S, n_in) → (S,) class predictions."""
    x_int = quantize_inputs(x01, spec.topo.input_bits)
    return torch.argmax(mlp_forward(spec, genome, x_int), dim=-1)


def accuracy(spec: GenomeSpec, genome: torch.Tensor, x01, labels) -> torch.Tensor:
    """() float32 accuracy of one chromosome on float [0,1] features: its
    correct count from the fitness dispatcher on a population of one (the
    kernel on a CUDA tensor, the plain path on a CPU one), then
    :func:`count_mean`."""
    from ..kernels.pop_mlp import population_correct  # lazy: kernels import core

    x_int = quantize_inputs(x01, spec.topo.input_bits)
    counts = population_correct(genome[None].contiguous(), x_int, labels, spec=spec)
    return count_mean(counts[0], labels.shape[-1])


def population_accuracy(spec: GenomeSpec, pop: torch.Tensor, x_int, labels,
                        out_mask=None) -> torch.Tensor:
    """(P, n_genes) × (S, n_in) → (P,) float32 accuracy (the untiled oracle)."""
    counts = population_correct_counts(spec, pop, x_int, labels, out_mask)
    return count_mean(counts, labels.shape[-1])


def population_correct_counts(spec: GenomeSpec, pop: torch.Tensor, x_int,
                              labels, out_mask=None) -> torch.Tensor:
    """(P, n_genes) × (S, n_in) → (P,) int32 correct-prediction counts.
    Labels of −1 (padded samples) never match."""
    pred = torch.argmax(mask_logits(mlp_forward(spec, pop, x_int), out_mask),
                        dim=-1)
    return (pred == labels).sum(dim=-1, dtype=torch.int32)


def population_correct_counts_mc(spec: GenomeSpec, pop: torch.Tensor, dev,
                                 gene_high, x_int, labels,
                                 out_mask=None) -> torch.Tensor:
    """(P, n_genes) × (K, n_genes) deltas → (P, K) int32 correct counts.

    Column k counts chromosome p perturbed to device instance k
    (:func:`~repro_torch.core.genome.apply_device_deltas` with ``dev[k]``
    and the exclusive bounds ``gene_high``). The deltas are zero off the
    exponent genes (``engine.device_deltas``), so layer 1's ``x & masks``
    is the same for every instance: it is computed once per chromosome
    and the K instance forwards reuse it, as in the reference."""
    K = dev.shape[0]
    n = spec.topo.n_layers
    bits = spec.topo.act_bits
    pert = apply_device_deltas(pop[:, None, :], dev[None], gene_high)  # (P, K, G)
    masks = spec.layer_params(pop, 0)[0]
    masked = torch.bitwise_and(x_int[None, :, :, None], masks[:, None])  # (P, S, I, H)
    counts = []
    for k in range(K):
        _, s, e, b, bs, rs = _sample_axis_params(spec, pert[:, k], 0)
        acc = ((s * torch.bitwise_left_shift(masked, e)).sum(dim=-2, dtype=torch.int32)
               + torch.bitwise_left_shift(b, bs))
        h = acc if n == 1 else qrelu(acc, rs, bits)
        for l in range(1, n):
            h = _layer_forward(h, *_sample_axis_params(spec, pert[:, k], l), bits,
                               is_last=(l == n - 1))
        pred = torch.argmax(mask_logits(h, out_mask), dim=-1)
        counts.append((pred == labels).sum(dim=-1, dtype=torch.int32))
    return torch.stack(counts, dim=-1)


# ---------------------------------------------------------------------------
# Exact fixed-point baseline inference (Table I semantics: 8-bit weights,
# 4-bit inputs, integer multipliers): the baseline accuracy.
# ---------------------------------------------------------------------------

def fixed_point_forward(weights_q, biases_q, x_int, act_bits: int = 8,
                        frac_bits: int = 7) -> torch.Tensor:
    """weights_q: int32 (fan_in, fan_out) tensors in Q1.(frac_bits) format;
    x_int (S, n_in) int32 → (S, n_out) int32 accumulators.

    The products are an integer broadcast-multiply-sum: CUDA has no int32
    matmul, and a float32 one would be exact only with TF32 off. The sums
    are exact (|acc| ≤ 255·255·fan_in < 2^24), and ``>>`` on int32 is an
    arithmetic shift, as the reference's."""
    h = x_int
    n = len(weights_q)
    for l, (w, b) in enumerate(zip(weights_q, biases_q)):
        acc = ((h.to(torch.int32)[..., :, None] * w.to(torch.int32)).sum(
            dim=-2, dtype=torch.int32) + b.to(torch.int32))
        if l < n - 1:
            h = torch.clamp(acc >> frac_bits, 0, 2**act_bits - 1)
        else:
            h = acc
    return h
