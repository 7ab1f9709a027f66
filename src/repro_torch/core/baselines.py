"""Baselines the paper compares against, PyTorch port of
``repro.core.baselines``.

1. ``train_float_mlp`` — conventional gradient training (paper Table III
   'Exec.Time Grad.'): plain MLP (:class:`FloatNet`), ReLU, cross-entropy,
   the reference's hand-written Adam step for step in float32.
2. ``exact_bespoke_baseline`` — [2]-style exact bespoke MLP: 8-bit
   fixed-point weights, 4-bit inputs, integer inference + array-multiplier
   FA-count cost (Table I analog).
3. ``calibrated_seeds`` — activation-calibrated doping genomes (§IV-A).
4. ``post_training_approx`` — [5]-style *post-training* approximation:
   round the trained weights to pow2, then greedily truncate mask LSBs while
   the accuracy budget holds (Fig. 4 analog).

Float training is not bit-identical across frameworks (matmul summation
orders, ``pow``), so it is held to stated tolerances. Initial weights come
from a ``torch.Generator`` on the CPU and are then moved to the run's
device, so a seed starts the same on the card and on the CPU; ``inits``
carries another framework's starting weights across instead. Everything
after the trained float weights is held bit for bit: fed the same
:class:`FloatMLP`, the integer outputs and accuracies equal the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from .area import baseline_mlp_fa, mlp_fa_count
from .engine import device_of
from .genome import GenomeSpec, MLPTopology
from .mlp import accuracy, count_mean, fixed_point_forward
from .quantize import fixed_point_quantize, quantize_inputs


@dataclasses.dataclass
class FloatMLP:
    """Trained float weights ((fan_in, fan_out) float32 numpy arrays, as the
    reference's) and their float accuracies."""

    weights: list[np.ndarray]
    biases: list[np.ndarray]
    train_acc: float
    test_acc: float


class FloatNet(torch.nn.Module):
    """``h @ w + b`` per layer, ReLU between layers (the reference's
    ``_forward``); ``w`` is (fan_in, fan_out) as the reference stores it."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
        super().__init__()
        self.weights = torch.nn.ParameterList([torch.nn.Parameter(w) for w in weights])
        self.biases = torch.nn.ParameterList([torch.nn.Parameter(b) for b in biases])

    @classmethod
    def from_numpy(cls, weights, biases, device="cpu") -> "FloatNet":
        """A net on ``device`` holding float32 copies of the arrays."""
        t = lambda ps: [torch.tensor(np.asarray(p, np.float32), device=device) for p in ps]
        return cls(t(weights), t(biases))

    @classmethod
    def draw(cls, sizes, seed: int) -> "FloatNet":
        """He-normal weights and 0.05 biases from a CPU ``torch.Generator``.

        The small positive bias: inputs are all-positive ([0, 1]) and the
        hidden layers are tiny (2–5 units), so a dead-ReLU collapse is a real
        failure mode at these widths."""
        gen = torch.Generator().manual_seed(seed)
        ws = [torch.randn(sizes[l], sizes[l + 1], generator=gen) * math.sqrt(2.0 / sizes[l])
              for l in range(len(sizes) - 1)]
        bs = [torch.full((sizes[l + 1],), 0.05) for l in range(len(sizes) - 1)]
        return cls(ws, bs)

    def hidden(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The post-ReLU activations of every hidden layer."""
        out, h = [], x
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            h = torch.relu(h @ w + b)
            out.append(h)
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.hidden(x)[-1] if len(self.weights) > 1 else x
        return h @ self.weights[-1] + self.biases[-1]

    def to_float_mlp(self, train_acc: float, test_acc: float) -> FloatMLP:
        as_np = lambda ps: [p.detach().cpu().numpy().astype(np.float32) for p in ps]
        return FloatMLP(as_np(self.weights), as_np(self.biases), train_acc, test_acc)


def fit_float_net(net: FloatNet, x: torch.Tensor, y: torch.Tensor, steps: int,
                  lr: float = 1e-2) -> torch.Tensor:
    """Adam on the mean cross-entropy, in place; → the (steps,) losses.

    The reference's Adam step for step: ``m = 0.9 m + 0.1 g``, ``v = 0.999
    v + 0.001 g²``, bias corrections ``1 - 0.9**t`` and ``1 - 0.999**t``
    with ``t`` float32, ``p -= lr · m̂ / (√v̂ + 1e-8)``. Nothing is read
    back to the host."""
    params = list(net.parameters())
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=x.device)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    c1 = one - torch.tensor(0.9, device=x.device) ** t
    c2 = one - torch.tensor(0.999, device=x.device) ** t
    rows = torch.arange(y.shape[0], device=x.device)
    losses = []
    for i in range(steps):
        logz = torch.log_softmax(net(x), dim=-1)
        loss = -torch.mean(logz[rows, y])
        grads = torch.autograd.grad(loss, params)
        losses.append(loss.detach())
        with torch.no_grad():
            for p, m_, v_, g in zip(params, m, v, grads):
                m_.copy_(0.9 * m_ + 0.1 * g)
                v_.copy_(0.999 * v_ + 0.001 * g * g)
                p.copy_(p - lr * (m_ / c1[i]) / (torch.sqrt(v_ / c2[i]) + 1e-8))
    return torch.stack(losses) if losses else torch.zeros(0, device=x.device)


def _float_accuracy(net: FloatNet, x: torch.Tensor, y: torch.Tensor) -> float:
    with torch.no_grad():
        pred = torch.argmax(net(x), dim=-1)
    return float(count_mean((pred == y).sum(dtype=torch.int32), y.shape[0]))


def train_float_mlp(topo: MLPTopology, x_train, y_train, x_test, y_test,
                    steps: int = 2000, lr: float = 1e-2, seed: int = 0,
                    restarts: int = 3,
                    inits: Optional[Sequence[tuple]] = None,
                    device="cuda") -> FloatMLP:
    """Adam-trained float MLP; the source of baseline accuracy + doping seeds.

    ``restarts`` independent runs, keep the best train accuracy (the first
    on a tie) — at widths of 2-5 hidden units single runs regularly
    collapse. Restart ``r`` starts from :meth:`FloatNet.draw` with seed
    ``seed + 7919 * r``, or from ``inits[r]``, a ``(weights, biases)`` pair
    of numpy lists, when given (:meth:`FloatNet.from_numpy`)."""
    dev = device_of(device)
    xtr = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    ytr = torch.as_tensor(np.asarray(y_train), device=dev).to(torch.int64)
    xte = torch.as_tensor(np.asarray(x_test, np.float32), device=dev)
    yte = torch.as_tensor(np.asarray(y_test), device=dev).to(torch.int64)
    best: FloatMLP | None = None
    for r in range(restarts):
        net = (FloatNet.draw(topo.sizes, seed + 7919 * r) if inits is None
               else FloatNet.from_numpy(*inits[r]))
        net = net.to(dev)
        fit_float_net(net, xtr, ytr, steps, lr)
        cand = net.to_float_mlp(_float_accuracy(net, xtr, ytr),
                                _float_accuracy(net, xte, yte))
        if best is None or cand.train_acc > best.train_acc:
            best = cand
    return best


@dataclasses.dataclass
class BespokeBaseline:
    accuracy: float
    fa_count: int
    weights_q: list[np.ndarray]
    biases_q: list[np.ndarray]
    frac_bits: int


def exact_bespoke_baseline(topo: MLPTopology, float_mlp: FloatMLP,
                           x_test, y_test, frac_bits: int = 5,
                           device="cuda") -> BespokeBaseline:
    """[2]-style exact baseline: 8-bit fixed weights, integer inference on
    ``device``.

    frac_bits picks the Q-format; 5 fractional bits keeps |w| ≤ 4
    representable, which covers trained weights on normalized [0,1] inputs.
    The accuracy is the float64 mean of the correct predictions, as the
    reference's ``np.mean``."""
    dev = device_of(device)
    wq = [fixed_point_quantize(torch.as_tensor(np.asarray(w, np.float32)),
                               topo.weight_bits, frac_bits).numpy()
          for w in float_mlp.weights]
    # biases live at the accumulator scale: x_int(4b) × w(Q·frac) → scale 15·2^f
    bq = [np.asarray(np.clip(np.round(np.asarray(b, np.float32) * 15 * 2**frac_bits),
                             -2**15, 2**15 - 1), np.int32) for b in float_mlp.biases]
    x = torch.as_tensor(np.asarray(x_test, np.float32), device=dev)
    x_int = quantize_inputs(x, topo.input_bits)
    logits = fixed_point_forward([torch.as_tensor(w, device=dev) for w in wq],
                                 [torch.as_tensor(b, device=dev) for b in bq],
                                 x_int, act_bits=topo.act_bits, frac_bits=frac_bits)
    y = torch.as_tensor(np.asarray(y_test), device=dev)
    correct = int((torch.argmax(logits, dim=-1) == y).sum())
    acc = correct / y.shape[0]
    fa = baseline_mlp_fa(topo.sizes, topo.weight_bits, topo.input_bits, topo.act_bits)
    return BespokeBaseline(acc, int(fa), wq, bq, frac_bits)


def calibrated_seeds(spec: GenomeSpec, float_mlp: FloatMLP, x01,
                     n_variants: int = 4, device="cuda") -> list[np.ndarray]:
    """Activation-calibrated 'nearly non-approximate' chromosomes (§IV-A doping).

    Chooses per-layer scales from the float net's actual activation ranges so
    the integer network tracks the float one:
      x_int ≈ α_l · x_float,  w_int = 2^k ≈ σ_l · w_float
      ⇒ acc_int ≈ α_l σ_l acc_float;  rshift picks α_{l+1} = (2^act_bits−1)/h_max.
    Returns ``n_variants`` genomes with jittered exponent scales σ_l (the GA
    refines from several starting scales). The hidden layers' maxima come
    from a float32 forward on ``device``; the rest is numpy float64, as the
    reference's."""
    topo = spec.topo
    dev = device_of(device)
    x = torch.as_tensor(np.asarray(x01, np.float32), device=dev)
    net = FloatNet.from_numpy(float_mlp.weights, float_mlp.biases, dev)
    with torch.no_grad():
        h_max = [float(torch.clamp_min(torch.max(h), 1e-6)) for h in net.hidden(x)]
    seeds = []
    for v in range(n_variants):
        g = np.zeros(spec.n_genes, np.int32)
        alpha = float(2**topo.input_bits - 1)  # x_int = round(x * 15)
        for l, sl in enumerate(spec.layers):
            wf = np.asarray(float_mlp.weights[l], np.float64)
            bf = np.asarray(float_mlp.biases[l], np.float64)
            absw = np.abs(wf[wf != 0])
            med = float(np.median(absw)) if absw.size else 1.0
            # median |w| → exponent (2 + variant jitter)
            sigma = (2.0 ** (2 + (v % 3))) / max(med, 1e-12)
            k = np.clip(np.round(np.log2(np.maximum(np.abs(wf) * sigma, 1e-12))),
                        0, topo.max_exp).astype(np.int32)
            s = (wf >= 0).astype(np.int32)
            g[sl.masks] = np.full(wf.size, 2**sl.in_bits - 1, np.int32)
            g[sl.signs] = s.reshape(-1)
            g[sl.exps] = k.reshape(-1)
            # bias at accumulator scale, mantissa + shift encoding
            bq = np.round(bf * alpha * sigma)
            mx = float(np.max(np.abs(bq))) if bq.size else 0.0
            bshift = max(0, int(np.ceil(np.log2(mx / 127.0))) if mx > 127 else 0)
            bshift = min(bshift, topo.max_exp)
            g[sl.biases] = np.clip(np.round(bq / 2.0**bshift),
                                   -(2 ** (topo.bias_bits - 1)),
                                   2 ** (topo.bias_bits - 1) - 1).astype(np.int32)
            g[sl.bshift.start] = bshift
            if l < topo.n_layers - 1:
                target = (2**topo.act_bits - 1) / h_max[l]   # α_{l+1}
                r = int(np.clip(np.round(np.log2(max(alpha * sigma / target, 1.0))),
                                0, 7))
                g[sl.rshift.start] = r
                alpha = alpha * sigma / 2.0**r
            else:
                g[sl.rshift.start] = 0
        seeds.append(g)
    return seeds


def post_training_approx(spec: GenomeSpec, float_mlp: FloatMLP,
                         x01, labels, max_loss: float = 0.05,
                         baseline_acc: float | None = None, device="cuda"):
    """[5]-style post-training approximation (greedy, accuracy-guarded).

    Start from the best calibrated pow2 chromosome (pow2 rounding of trained
    weights, full masks) and greedily clear mask bits — lowest-significance
    first, weight-by-weight — accepting each step that keeps accuracy within
    ``max_loss`` of the baseline. Returns (genome, accuracy, fa_count).

    Each trial is one fitness launch on a population of one and one host
    read: every step starts from the one before, so the loop is sequential,
    and each accept test compares the float32 accuracy, as a Python float,
    with the floor, as the reference's."""
    dev = device_of(device)
    cands = calibrated_seeds(spec, float_mlp, x01, device=dev)
    x = torch.as_tensor(np.asarray(x01, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(labels), device=dev).to(torch.int32)

    def eval_acc(g) -> float:
        return float(accuracy(spec, torch.as_tensor(g, device=dev), x, y))

    accs = [eval_acc(g) for g in cands]
    genome = np.array(cands[int(np.argmax(accs))])
    acc0 = baseline_acc if baseline_acc is not None else eval_acc(genome)
    floor_acc = acc0 - max_loss

    for sl in spec.layers:
        for bit in range(sl.in_bits):           # LSB → MSB
            for gi in range(sl.masks.start, sl.masks.stop):
                if not genome[gi] & (1 << bit):
                    continue
                trial = genome.copy()
                trial[gi] &= ~(1 << bit)
                a = eval_acc(trial)
                if a >= floor_acc:
                    genome = trial
    fa = int(mlp_fa_count(spec, torch.as_tensor(genome, device=dev)))
    return genome, eval_acc(genome), fa
