"""Integer forward pass of the approximate printed MLP — paper Eq. (4):

    y_j = QReLU( Σ_i s_ij · ((m_ij ⊙ x_i) ≪ k_ij) + b_j )

PyTorch counterpart of ``repro.core.mlp``. All arithmetic is int32 and
wraps like XLA's: sums take ``dtype=torch.int32`` (torch would widen them
to int64), and torch's shifts give 0 (left) or the sign fill (right) for
amounts outside [0, 31], as XLA's do. Argmax returns the first maximum.
"""
from __future__ import annotations

import torch

from .genome import GenomeSpec
from .quantize import qrelu

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


def mlp_forward(spec: GenomeSpec, genome: torch.Tensor,
                x_int: torch.Tensor) -> torch.Tensor:
    """Forward of a genome (G,) or a population (P, G) over x_int
    (S, n_in) → (S, n_out) or (P, S, n_out) int32 logits."""
    lead = genome.shape[:-1]
    h = x_int.expand(lead + x_int.shape)
    n = spec.topo.n_layers
    for l in range(n):
        masks, signs, exps, bias, bshift, rshift = spec.layer_params(genome, l)
        # a sample axis sits between the population axis and the gene axes
        ins = lambda t: t.reshape(lead + (1,) + t.shape[len(lead):])
        h = _layer_forward(h, ins(masks), ins(signs), ins(exps), ins(bias),
                           bshift.reshape(lead + (1, 1)),
                           rshift.reshape(lead + (1, 1)),
                           spec.topo.act_bits, is_last=(l == n - 1))
    return h


def population_accuracy(spec: GenomeSpec, pop: torch.Tensor, x_int, labels,
                        out_mask=None) -> torch.Tensor:
    """(P, n_genes) × (S, n_in) → (P,) float32 accuracy (the untiled oracle).

    The reference's ``jnp.mean`` compiles under jit to the 0/1 sum times
    float32 ``1/S``, rounded once (not ``sum / S``); so is this."""
    counts = population_correct_counts(spec, pop, x_int, labels, out_mask)
    inv = torch.tensor(1.0 / labels.shape[-1], dtype=torch.float32, device=counts.device)
    return (counts.to(torch.float64) * inv.to(torch.float64)).to(torch.float32)


def population_correct_counts(spec: GenomeSpec, pop: torch.Tensor, x_int,
                              labels, out_mask=None) -> torch.Tensor:
    """(P, n_genes) × (S, n_in) → (P,) int32 correct-prediction counts.
    Labels of −1 (padded samples) never match."""
    pred = torch.argmax(mask_logits(mlp_forward(spec, pop, x_int), out_mask),
                        dim=-1)
    return (pred == labels).sum(dim=-1, dtype=torch.int32)
