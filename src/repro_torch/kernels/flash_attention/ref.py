"""Plain PyTorch version of the causal flash attention kernel, and the limit
that holds the kernel to it in bfloat16."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _causal_softmax(q, k, head_dim=None):
    """The float32 (BH, S, S) causal softmax of q·kᵀ/√D, D = ``head_dim`` or
    q's width, keys after the query masked to -1e30."""
    S, D = q.shape[1], head_dim or q.shape[2]
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(1, 2)) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = torch.where((pos[:, None] >= pos[None, :])[None], s, NEG_INF)
    return torch.softmax(s, dim=-1)


def flash_attention_ref(q, k, v, head_dim=None):
    """q/k: (BH, S, D); v: (BH, S, Dv) → (BH, S, Dv) in q's type: the dense
    causal softmax. Scores are float32 products divided by √D (by
    √head_dim when it is given: q and k padded with zero columns keep the
    unpadded width's scale), keys after
    the query are masked to -1e30, p is cast to v's type before P·V and the
    product accumulates in float32 (every operand cast to float32, exact for
    bf16). The caller keeps ``torch.backends.cuda.matmul.allow_tf32`` False
    on the card."""
    p = _causal_softmax(q, k, head_dim)
    f32 = torch.float32
    return torch.matmul(p.to(v.dtype).to(f32), v.to(f32)).to(q.dtype)


def flash_attention_bf16_limit(q, k, v, plain):
    """Per-element limit on |out - plain| for a bfloat16 attention ``out``
    computed in another order than ``plain = flash_attention_ref(q, k, v)``:
    ``2^-7·|plain| + 2^-5·sqrt(Σ_j p_j² v_j²)``, in float32.

    Two roundings separate the kernel from its plain version. (1) Each
    rounds its float32 output to bf16 (8 significant bits), so the two land
    at most one unit in the last place apart, ≤ 2^-7·|plain|. (2) Each rounds
    p to bf16 before P·V, the kernel exp(s - running max) and the plain
    version the normalised softmax, so the float32 sums differ by Σ_j p_j
    v_j ε_j with |ε_j| ≤ 2^-7 (two roundings of at most 2^-8 each). These
    errors are independent across keys; their sum has a standard deviation
    of about 2^-8.8·sqrt(Σ_j p_j² v_j²), so the second term is some 14 such
    deviations. For a row with at most 16 keys it also bounds the worst case
    2^-7·Σ_j p_j |v_j| (Cauchy–Schwarz). The limit scales with each row:
    late rows of a long sequence, whose outputs are small averages, get a
    small limit, so a dropped, doubled or shifted key tile shows there."""
    p = _causal_softmax(q, k)
    f32 = torch.float32
    spread = torch.matmul(p * p, v.to(f32).square()).sqrt()
    del p
    return 2.0 ** -7 * plain.to(f32).abs() + 2.0 ** -5 * spread
