#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a mismatch raises, nothing falls back):

1. device — the card's name, and ``nvidia-smi``'s name and power limit;
2. build — the CUDA kernels from ``src/repro_torch/csrc`` into one
   shared library (nvcc, sm_90a, one compile per source, started
   together, then one link), with ptxas's report (registers, shared
   memory, spills) on both K6 kernels, one line per compiled width, on both
   K7 kernels, and on the table kernels (K1, K4, both branches of K3) per
   compiled set of widths, and the table kernels' shared memory per block
   as their launchers ask for it (which the wrappers check, and
   ``ref.mc_smem_bytes``, ``ref.k1_smem_bytes``,
   ``ref.generation_smem_bytes`` and ``ref.generation_mc_smem_bytes``
   must match);
3. kernels vs plain — each kernel's wrapper against its plain PyTorch
   version on the same CUDA tensors at the main path's shapes (pendigits
   and breast_cancer, pop 256, K = 8 device instances), exact equality
   (tolerance 0: integer outputs); the device-instance kernels with an
   all-zero delta table equal the nominal kernels; the GA kernels' lane
   axis at the suite's 15 padded lanes, one launch for all lanes;
4. end to end, two paths, each with the launch counts set to 0 just
   before it and read just after — ``GATrainer.run`` at pendigits width
   (16, 5, 10), pop 256, with generation backends auto (megakernel), ref
   (EvalCache + fitness kernel) and phases (variation kernel + fitness
   kernel): the nominal path (``variation_mode="off"``) and the
   device-variation Monte-Carlo path (``variation_mode="mean"``, K = 8).
   On each path the three final states must be bit-identical and every
   kernel of the path must launch; small breast_cancer runs (off, worst,
   mean) on the card must equal the plain runs on the CPU;
4b. the batched entry points, each a path of its own with the launch
   counts set to 0 just before it and read just after, each launching its
   kernels once per generation for all lanes: ``run_suite`` over the
   paper's five datasets x 3 seeds (15 lanes, pop 64, 20 generations,
   each dataset doped with its 4 calibrated genomes and bounded by its
   bespoke baseline, generation auto), ``run_grid`` at
   pendigits pop 256 (2 seeds x 3 mutation rates, 10 generations,
   generation ref and phases) and ``run_batch`` on the device-variation
   path (pendigits pop 256, seeds 0 and 1, K = 8); every cell must equal
   its sequential unpadded ``GATrainer.run`` on the card (every field, the
   EvalCache, ``unique_evals``, ``cache_hits``); a small doped suite on the
   card must equal the CPU's, and a generation-"ref" run that makes EvalCache
   hits must equal the CPU's, cache included;
4c. the fallback chain's probe: ``resolve_backends(..., fallback=True)``
   must launch the probe kernel once, downgrade nothing and warn nothing,
   then answer from its memo;
4d. the paper's pipeline at pendigits (``examples/quickstart.py``):
   ``train_float_mlp`` on the card (800 steps, 3 restarts), its train
   accuracy within 0.002 of the same training on the CPU from the same
   CPU-drawn weights; ``exact_bespoke_baseline`` and ``calibrated_seeds``
   on the card equal to the CPU's on that net, bit for bit; the doped
   ``GATrainer.run`` (baseline the bespoke accuracy, pop 256, 20
   generations) under generation auto and phases, bit-identical, each a
   counted path launching K3, or K2 and K1; ``best_within_loss`` on its
   front; ``post_training_approx`` on the card (one K1 launch a trial,
   counted) equal to the CPU's; ``emit_verilog`` of the chosen design,
   whose simulated predictions (``evaluate_genome_python``) equal
   ``mlp_predict`` on the card and whose correct count equals K1's. The
   suite of 4b runs on each dataset's calibrated genomes and bespoke
   baseline, from one float net per dataset made here;
4e. the islands (``core.islands`` on a one-card ``DeviceMesh``), each path
   with the launch counts set to 0 just before it and read just after: one
   island at pendigits pop 256 (20 generations in one round) equals
   ``GATrainer.run`` on the card, every carry leaf; 16 islands x 64 rows at
   pendigits (3 rounds x 10 generations, 4 migrants) under generation auto
   and phases give bit-identical final carries, launching K3, or K2 and
   K1, once a generation for all islands; the small breast_cancer rings of
   ``tests/test_torch_islands.py`` (4 islands with dedup off and on and
   under ``variation_mode="mean"``, and 2 x 2) on the card equal the CPU's
   after init and after every round, every carry leaf but the EvalCache
   (which generation auto's kernel path carries through and the CPU's
   "ref" updates), launching K1 and K3 or K4 and K3 ``n_dev``;
   ``[islands]`` lines give the wall time per round and per generation,
   one batched generation's ranking share and the ring's migration time;
4f. the search server (``repro_torch.serve.SearchServer``), each stream a
   path with the launch counts set to 0 just before it and read just
   after: the suite as a stream of 8 jobs (the five datasets, and
   pendigits seeds 1 and 2 and cardio seed 1; budgets 5 to 20, each doped
   with its calibrated genomes against its bespoke baseline) on 4 lanes in
   segments of 5, longest budget first, under generation auto and phases:
   every retired job equals its standalone ``GATrainer.run`` on the card
   (every field, ``unique_evals``, ``cache_hits``), K1 launches once per
   admission and K3 (or K2 and K1) once per generation with an active
   lane, and K3's lanes summed over its launches equal the jobs' budgets
   (a retired or empty lane is in no launch); a 2-lane device-variation
   stream (breast_cancer and redwine, K = 8) launches K4 and K3 ``n_dev``
   the same way and equals its trainers; ``validate_state`` holds on every
   busy lane at every boundary, a NaN written into one lane flags
   ``finite_objectives`` there alone and ``quarantine_lane`` frees it;
   ``[serve]`` lines give the wall time per segment, the generations per
   second summed over the lanes and the makespan, beside a 4-lane batched
   generation of ``run_suite``'s kind;
4g. the supervised server (``repro_torch.serve.Supervisor``, checkpoints
   every 2 segments into a temporary directory): a checkpoint of a card
   server after one segment of 4f's suite stream, its bytes reckoned from
   the shapes, saved, verified and restored on the card and on the CPU,
   every leaf equal to the card server's; then two counted paths: 4f's
   auto stream supervised without faults (every job equal to 4f's result,
   K1 once per admission, K3 once per generation with an active lane, its
   lanes summing to the budgets), and the same stream under a fault
   schedule (a segment fault and a checkpoint IO error, both retried; lane
   0 poisoned and quarantined, naming ``finite_objectives``; step 4
   bit-rotted after its save; a kill after segment 4), recovered in the
   same process from step 2 with ``dropped_pending`` resubmitted and
   drained: every healthy result equal to 4f's, the stats at the kill and
   after the recovery, K1 (admissions and the recovered server), K3 and
   its lanes as reckoned from the schedule alone, replays included;
   ``[supervisor]`` lines give the checkpoint's bytes, the save, verify and
   restore times, the supervised stream's wall time against the bare
   one's and the share of validation and checkpoints;
5. LM-side ops, the third path, with the launch counts set to 0 just
   before it and read just after — ``state_scan`` at mamba2-130m width,
   ``pow2_linear`` at qwen3-14b's FFN projection (bf16 tokens, weights
   packed on the card by ``pack_weights``) and ``causal_attention`` at
   qwen3-14b prefill (bf16), each through its op with ``use_kernel=None``;
   each must launch its kernel and agree with its plain version: the state
   scan bit for bit, the pow2 product within 1e-4 of the plain output's
   largest magnitude, bf16 attention within ``flash_attention_bf16_limit``
   at every element (the worst ratio to it printed); then float32 cases
   of the attention (3e-4) and the pow2 product (1e-4);
6. numbers — per kernel: the device time of its launch alone, operands
   prepared once (50 launches captured in a CUDA graph, replayed between
   CUDA events), the same for the whole wrapper, the time of a wrapper
   call from the host and of the plain version (CUDA events around the
   calls), the bound (the operations over the busiest SM pipe or the
   issue rate, or the bytes over 3.35 TB/s, whichever is larger),
   launches; and a whole generation. The LM-side kernels the same way
   (fewer launches per graph for those that run for milliseconds), their
   bound the larger of the bytes over 3.35 TB/s, the products over the
   bf16 tensor cores (989 TFLOP/s) or the float32 pipe (67 TFLOP/s) and
   the exponentials over the special-function units, with the time of one
   PyTorch call computing the same function beside them (never called by
   the port): for K7 on the weights decoded once, ``torch.mm(...,
   out_dtype=torch.float32)`` in bf16 (the kernel's float32 output;
   ``torch.matmul`` where this torch refuses it, both printed) and
   ``torch.matmul`` in float32,
   ``scaled_dot_product_attention`` for K6 in bf16 and in float32, pinned
   to the fastest of its backends that take the inputs (each backend's
   time and the unpinned call's are printed, the chosen one named). The
   lane axis: each GA kernel's launch
   for the suite's 15 lanes against the same work as 15 single-lane
   launches (both CUDA graphs), and a batched generation of the suite with
   its ranking's share against 15 single-lane generations; the probe.

The last three lines are the card's name and power limit, the ``kernels``
JSON object (nine rows, the lane-axis numbers under ``lane_axis`` in the
GA kernels' rows, the float32 cases of K6 and K7 under ``float32`` in
their rows; every number in it but ``bound_ms`` measured in this run) and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
TENSOR_BF16_FLOPS = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
FP32_FLOPS = 67e12              # H100 SXM data sheet, float32 outside the tensor cores
# exponentials per SM and clock on the special-function units (CUDA C++
# Programming Guide, compute capability 9.0: base-2 exponential 16)
SFU_RATE = 16
# LM-side ops at the full width of configurations the repo ships
# (src/repro/configs/registry.py)
SSD_SHAPE = (8, 8, 24, 64, 128)   # mamba2-130m: batch 8 x 2048 tokens in chunks of 256,
#                                   H = 768 * 2 / 64 heads, headdim 64, d_state 128
ATTN_SHAPE = (40, 4096, 128, 128)  # qwen3-14b prefill: 40 query heads, S, D = Dv = 128
FFN_SHAPE = (4096, 5120, 17408)    # qwen3-14b FFN: M tokens, K = d_model, N = d_ff
FFN_F32_M = 512
LM_KERNELS = ("ssd_state_scan", "pow2_matmul", "flash_attention")
GENERATIONS = 20
K_DEV = 8                       # GAConfig.n_device_samples default
FIELDS = ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen")
CACHE = ("cache.rows", "cache.vals", "cache.stamp")
# the kernels each end-to-end path must launch
PATH_KERNELS = {"off": ("pop_mlp_correct", "pop_variation_kernel", "pop_generation_kernel"),
                "mean": ("pop_mlp_correct_mc", "pop_variation_kernel",
                         "pop_generation_kernel_mc")}


def nvidia_smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host time
    sits between the launches (``fn`` must not read or copy from the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# Least-time model of the integer SIMT work. Per-SM results per clock,
# compute capability 9.0 (CUDA C++ Programming Guide, table "Throughput of
# Native Arithmetic Instructions"): 32-bit integer add, logic, shift,
# compare, min/max and select 64 (the ALU pipe); 32-bit integer multiply-add
# 64 (the FMA pipe, which runs IMAD beside the float work: Nsight Compute's
# pipeline list); 32-bit float add/multiply/compare 128; float <-> int
# conversions 16. Each of the 4 schedulers of an SM issues one warp
# instruction per clock: 128 thread instructions per SM and clock in all.
# "any" counts 3-input adds, which the compiler places on either pipe (IADD3
# or IMAD.IADD), so they bound only through the issue rate.
PIPE_RATES = {"alu": 64, "imad": 64, "fp32": 128, "cvt": 16}
ISSUE_RATE = 128


def ops_add(*terms):
    """Sum of ``(count, ops-per-pipe dict)`` terms → one ops-per-pipe dict."""
    out = dict.fromkeys((*PIPE_RATES, "any"), 0)
    for n, ops in terms:
        for k, v in ops.items():
            out[k] += n * v
    return out


def forward_ops(topo) -> dict:
    """Operations of one (chromosome, sample) forward + argmax + label
    compare, as the function needs them. A weight term is
    ``sign * ((x & mask) << exp)``; ``sign << exp`` depends only on the
    chromosome, so a weight costs one AND and one multiply-add into the
    accumulator, which starts at the chromosome's shifted bias. A hidden
    neuron's QReLU is a shift, a max and a min; the first-maximum argmax
    a compare and two selects per output after the first; the count a
    compare and an add."""
    w = sum(topo.sizes[l] * topo.sizes[l + 1] for l in range(topo.n_layers))
    hidden = sum(topo.sizes[1:-1])
    return {"alu": w + 3 * hidden + 3 * (topo.sizes[-1] - 1) + 1, "imad": w, "any": 1}


def chromosome_ops(topo) -> dict:
    """Per chromosome, once: each weight's ``sign << exp`` (shift, range
    select, sign select) and each neuron's shifted bias (shift, select)."""
    w = sum(topo.sizes[l] * topo.sizes[l + 1] for l in range(topo.n_layers))
    return {"alu": 3 * w + 2 * sum(topo.sizes[1:])}


# One Threefry-2x32: 20 rounds of add, rotate (one funnel shift) and xor;
# the key injection into the second word is one 3-input add (key word plus
# round constant) each of the 5 times, the injections into the first word
# and its initial add fold into the next round's 3-input add but for the
# last, and the second word's initial add is one more.
THREEFRY_OPS = {"alu": 40, "any": 27}
# uint32 bits -> float in [0, 1): shift, or with the exponent, subtract 1.0
TO_FLOAT_OPS = {"alu": 2, "fp32": 1}
# one child gene, besides its draws: swap gate from the swap word's sign
# bit (u < 0.5 is bit 31 clear) and the pair's gate (2), source select (1),
# mutation gate compare (fp32 1), bit flip: u * bits, floor, shift, xor
# (fp32 1, cvt 1, alu 2), reset: lo + u * span, floor (fp32 2, cvt 1), two
# selects (2), clip (2)
GENE_OPS = {"alu": 9, "fp32": 4, "cvt": 2}
# per gene column, once: lo, span and bit count to float, span, max(bits, 1)
COLUMN_OPS = {"cvt": 3, "any": 1, "alu": 1}


def variation_ops(P: int, G: int) -> dict:
    """Operations of ``P`` children of ``G`` genes: the swap words come two
    parent pairs to a Threefry evaluation, the mutation-gate and -value
    words two rows to one, and each child gene turns its two mutation words
    into floats."""
    half = P // 2
    n_tf = ((half + 1) // 2) * G + 2 * half * G
    return ops_add((n_tf, THREEFRY_OPS), (2 * P * G, TO_FLOAT_OPS),
                   (P * G, GENE_OPS), (G, COLUMN_OPS))


def fitness_ops(topo, P: int, S: int) -> dict:
    return ops_add((P * S, forward_ops(topo)), (P, chromosome_ops(topo)))


def fitness_mc_ops(topo, P: int, S: int, K: int, n_moved: int) -> dict:
    """K instances of the forward per (chromosome, sample), with layer 1's
    ``x & mask`` counted once (it does not depend on the instance: the
    deltas move exponents only); per (chromosome, instance) the per-
    chromosome work, and per gene the deltas move (``n_moved`` nonzero
    entries of the (K, G) table, as this run's deltas have) an add and a
    clip into [0, high - 1] (max, min)."""
    and1 = topo.sizes[0] * topo.sizes[1]
    per_sample = forward_ops(topo)
    shared = {"alu": and1}
    rest = dict(per_sample, alu=per_sample["alu"] - and1)
    return ops_add((P * S, shared), (P * S * K, rest), (P * K, chromosome_ops(topo)),
                   (P * n_moved, {"alu": 3}))


def bound(ops: dict, nbytes: int, n_sm: int, clock_hz: float):
    """(least ms, "operations" or "bytes", the term that bounds): the larger
    of the bytes over HBM's rate and the operations over the busiest of the
    SM's pipes and its issue rate."""
    terms = {k: ops[k] / r for k, r in PIPE_RATES.items()}
    terms["issue"] = sum(ops.values()) / ISSUE_RATE
    pipe = max(terms, key=terms.get)
    t_ops = terms[pipe] / (n_sm * clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", pipe)


def require_equal(name: str, got, want) -> int:
    """Exact equality of two integer tensors; returns max |difference|."""
    import torch

    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.long() - want.long()).abs().max().item() if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs diff {diff})")
    return 0


def require_within(name: str, got, want, limit):
    """|got - want| <= limit everywhere (in float32; ``limit`` a number or a
    tensor of got's shape); returns |got - want|."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: kernel gives {tuple(got.shape)} {got.dtype}, plain "
                             f"version {tuple(want.shape)} {want.dtype}")
    g = got.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output not finite")
    diff = (g - want.float()).abs()
    if not (diff <= limit).all():
        worst = (diff / limit).max().item()
        raise AssertionError(f"{name}: kernel differs from its plain version beyond its "
                             f"limit (max abs diff {diff.max().item()}, {worst:.3g} x limit)")
    return diff


def require_close(name: str, got, want, atol: float, rtol: float) -> float:
    """|got - want| <= atol + rtol * |want| everywhere; returns max
    |difference|."""
    return require_within(name, got, want, atol + rtol * want.float().abs()).max().item()


def entry_ptxas(log: str, source: str, entries: dict) -> list:
    """ptxas's report on chosen kernels of one source, one line per
    compiled entry: registers (at entry, for the warp-specialised kernels:
    setmaxnreg then moves them between the warpgroups), static shared
    memory, stack and spill bytes, and any warning of that source.
    ``entries`` maps a regex on the mangled entry name to a label
    (``{0}``, ``{1}``: its groups)."""
    section = log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0]
    lines, entry = [], None
    for line in section.splitlines():
        if "Compiling entry" in line:
            entry = next((label.format(*m.groups()) for pat, label in entries.items()
                          if (m := re.search(pat, line))), None)
        elif "warning" in line.lower():
            lines.append(f"ptxas {line.strip()}")
        elif entry and ("registers" in line or "spill" in line):
            lines.append(f"{entry}: {line.split(':')[-1].strip()}")
    return lines


KERNEL_ENTRIES = {
    "flash_attention": {r"flash_attention_sm90ILi(\d+)ELi(\d+)E":
                        "K6 bf16 flash_attention_sm90<{0}, {1}>",
                        r"flash_attention_f32ILi(\d+)ELi(\d+)E":
                        "K6 float32 flash_attention_f32<{0}, {1}>"},
    "pow2_matmul": {r"pow2_matmul_sm90": "K7 bf16 pow2_matmul_sm90",
                    r"pow2_matmul_f32": "K7 float32 pow2_matmul_f32"},
    "pop_mlp": {r"pop_mlp_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb1E":
                "K4 pop_mlp_tables_kernel<{0}, {1}, {2}, true>",
                r"pop_mlp_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0E":
                "K1 pop_mlp_tables_kernel<{0}, {1}, {2}, false>"},
    "pop_generation": {r"pop_generation_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb1E":
                       "K3 n_dev pop_generation_tables_kernel<{0}, {1}, {2}, true>",
                       r"pop_generation_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0E":
                       "K3 nominal pop_generation_tables_kernel<{0}, {1}, {2}, false>"},
}
# The redesigned kernels' times before their redesign, quoted from PERF.md's
# kernel table (chip_smoke.py's own run before the redesign, NVIDIA H100 80GB
# HBM3 at 700 W) and printed, labelled so, beside the times this run measures;
# they are kept out of the kernels line, which holds this run's numbers
EARLIER_MS = {"pop_mlp_correct": 0.3962, "pop_mlp_correct lanes": 0.7380,
              "pop_generation_kernel_mc": 2.4148, "pop_generation_kernel_mc lanes": 4.9892,
              "pop_mlp_correct_mc": 2.5364, "pop_mlp_correct_mc lanes": 4.4008,
              "pop_generation_kernel": 0.3336, "pop_generation_kernel lanes": 0.6035,
              "flash_attention float32": 9.1310}


def launch_smem(kernel: str, sizes, n_dev: int = 1) -> int:
    """A table kernel's shared memory per block as its launcher asks for it
    on this card (the size its wrapper checks): ``kernel`` "K4"
    (``pop_mlp_correct_mc_smem_bytes``), "K1" (``pop_mlp_correct_smem_bytes``),
    "K3" (the n_dev branch, ``pop_generation_mc_smem_bytes``) or "K3N" (the
    nominal branch, ``pop_generation_smem_bytes``); raises
    unless its CPU mirror in ``kernels/pop_mlp/ref.py`` computes the same
    for the card's limit."""
    import ctypes

    import torch

    from repro_torch.core.genome import GenomeSpec, MLPTopology
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pop_mlp import ref
    from repro_torch.kernels.pop_mlp.kernel import net_desc

    spec = GenomeSpec(MLPTopology(sizes))
    desc = ctypes.cast(_cuda.host_ints(net_desc(spec)), ctypes.c_void_p)
    lib = _cuda.library()
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    got, want = {
        "K4": (lambda: lib.pop_mlp_correct_mc_smem_bytes(desc, n_dev),
               lambda: ref.mc_smem_bytes(sizes, n_dev, limit)),
        "K1": (lambda: lib.pop_mlp_correct_smem_bytes(desc),
               lambda: ref.k1_smem_bytes(sizes, limit)),
        "K3": (lambda: lib.pop_generation_mc_smem_bytes(desc, spec.n_genes, n_dev),
               lambda: ref.generation_mc_smem_bytes(sizes, spec.n_genes, n_dev, limit)),
        "K3N": (lambda: lib.pop_generation_smem_bytes(desc, spec.n_genes),
                lambda: ref.generation_smem_bytes(sizes, spec.n_genes, limit)),
    }[kernel]
    if got() != want():
        raise AssertionError(f"{kernel} at {sizes}, K={n_dev}: the launcher asks for {got()} "
                             f"bytes of shared memory, its CPU mirror gives {want()}")
    return got()


def sdpa(q, k, v):
    """The yardstick for K6: causal ``scaled_dot_product_attention`` on
    (BH, S, D) tensors, each backend that takes them pinned and timed.
    Returns (the fastest backend's call, its name, {name: ms} for every
    backend that ran, and the unpinned call's ms)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def default():
        return F.scaled_dot_product_attention(q[None], k[None], v[None], is_causal=True)

    calls, times = {}, {}
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH"):
        def call(backend=SDPBackend.__members__[name]):
            with sdpa_kernel([backend]):
                return default()
        try:
            with warnings.catch_warnings():   # a refusing backend warns why
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:
            continue
        calls[name], times[name] = call, time_ms(call, reps=3, warmup=1)
    best = min(times, key=times.get)
    return calls[best], best, times, time_ms(default, reps=3, warmup=1)


def lm_path(dev) -> dict:
    """Phase 5: the LM-side ops at full width through their public entry
    points, counted; each output held against its plain version."""
    import torch
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.flash_attention import (causal_attention, flash_attention,
                                                     flash_attention_bf16_limit,
                                                     flash_attention_plain)
    from repro_torch.kernels.pow2_matmul import (pack_weights, pow2_linear, pow2_matmul,
                                                 pow2_matmul_plain)
    from repro_torch.kernels.ssd_scan import ssd_state_scan_plain, state_scan

    g = torch.Generator(device=dev).manual_seed(0)
    state_c = torch.randn(SSD_SHAPE, generator=g, device=dev)
    decay = torch.rand(SSD_SHAPE[:3], generator=g, device=dev)   # exp(-dt A) lies in (0, 1)
    BH, S, D, Dv = ATTN_SHAPE
    q, k, v = (torch.randn((BH, S, d), generator=g, device=dev).to(torch.bfloat16)
               for d in (D, D, Dv))
    M, K, N = FFN_SHAPE
    x = torch.randn((1, M, K), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    wp = pack_weights(w)
    require_equal("pack_weights card vs CPU (first 64 rows)", wp[:64].cpu(),
                  pack_weights(w[:64].cpu()))
    del w
    torch.cuda.synchronize()

    _cuda.reset_launches()
    h_prev = state_scan(state_c, decay)
    y = pow2_linear(x, wp)
    o = causal_attention(q, k, v)
    torch.cuda.synchronize()
    launches = {n: _cuda.LAUNCHES[n] for n in LM_KERNELS}
    missing = [n for n in LM_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"LM ops: kernels never launched through their ops: {missing}")

    err = {}
    want = ssd_state_scan_plain(state_c, decay)
    err["ssd_state_scan"] = require_equal("ssd_state_scan vs plain",
                                          h_prev.view(torch.int32), want.view(torch.int32))
    if (h_prev[:, 0] != 0).any() or not torch.isfinite(h_prev).all():
        raise AssertionError("ssd_state_scan: chunk 0 not zero or output not finite")
    del want
    want = pow2_matmul_plain(x[0], wp)
    scale = want.abs().max().item()
    err["pow2_matmul"] = require_close("pow2_linear bf16 vs plain", y[0], want,
                                       1e-4 * scale, 0.0)
    mm_ratio = err["pow2_matmul"] / (1e-4 * scale)
    del want, y
    # bf16: one bf16 unit of the output plus the spread of p's bf16 rounding
    # (flash_attention_bf16_limit), a limit that shrinks with the late rows'
    # small outputs
    want = flash_attention_plain(q, k, v)
    limit = flash_attention_bf16_limit(q, k, v, want)
    diff = require_within("causal_attention bf16 vs plain", o, want, limit)
    err["flash_attention"] = diff.max().item()
    late = slice(S - S // 4, S)
    fa_bf16 = dict(ratio=(diff / limit).max().item(), late_err=diff[:, late].max().item(),
                   late_limit=limit[:, late].median().item(),
                   late_out=want[:, late].float().abs().median().item())
    del o, want, limit, diff
    torch.cuda.empty_cache()
    q32, k32, v32 = q.float(), k.float(), v.float()
    err_fa32 = require_close("flash_attention float32 vs plain", flash_attention(q32, k32, v32),
                             flash_attention_plain(q32, k32, v32), 3e-4, 3e-4)
    x32 = torch.randn((FFN_F32_M, K), generator=g, device=dev)
    want = pow2_matmul_plain(x32, wp)
    scale32 = want.abs().max().item()
    err_mm32 = require_close("pow2_matmul float32 vs plain", pow2_matmul(x32, wp), want,
                             1e-4 * scale32, 0.0)
    torch.cuda.empty_cache()
    print(f"[lm] state_scan {SSD_SHAPE} f32 (mamba2-130m), pow2_linear x {tuple(x.shape)} bf16 "
          f"x w {tuple(wp.shape)} uint8 (qwen3-14b FFN), causal_attention {ATTN_SHAPE} bf16 "
          f"(qwen3-14b prefill) through their ops: launches {launches}; vs plain: state scan "
          f"bit for bit, pow2 max abs diff {err['pow2_matmul']:.3g} (limit 1e-4 x "
          f"{scale:.4g}; {mm_ratio:.3g} x the limit at worst), attention bf16 {err['flash_attention']:.3g} ({fa_bf16['ratio']:.3g} x "
          f"the bf16 limit at worst; last quarter of the rows: max abs diff "
          f"{fa_bf16['late_err']:.3g}, median limit {fa_bf16['late_limit']:.3g}, median "
          f"|plain| {fa_bf16['late_out']:.3g}), float32 cases: attention {err_fa32:.3g} (3e-4), pow2 M={FFN_F32_M} "
          f"{err_mm32:.3g} (1e-4 x max; {err_mm32 / (1e-4 * scale32):.3g} x the limit at "
          f"worst)")
    err["flash_attention float32"], err["pow2_matmul float32"] = err_fa32, err_mm32
    return dict(state_c=state_c, decay=decay, q=q, k=k, v=v, q32=q32, k32=k32, v32=v32,
                x=x[0], x32=x32, wp=wp, launches=launches, err=err)


def lm_numbers(lm: dict, n_sm: int, clock_hz: float, smi: str) -> list:
    """Phase 6 for the LM-side kernels: the ``kernels`` rows."""
    import torch
    from repro_torch.core.quantize import pow2_dequantize
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_call,
                                                            flash_attention_plain)
    from repro_torch.kernels.pow2_matmul.kernel import pow2_matmul_call, pow2_matmul_plain
    from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan_call, ssd_state_scan_plain

    def tc_bound(flops, peak, nbytes, exps=0):
        terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": flops / peak,
                 "exponentials": exps / (SFU_RATE * n_sm * clock_hz)}
        by = max(terms, key=terms.get)
        return terms[by] * 1e3, "bytes" if by == "bytes" else "operations", by

    b, nc, H, P, N = SSD_SHAPE
    BH, S, D, Dv = ATTN_SHAPE
    M, K, Nf = FFN_SHAPE
    pairs = S * (S + 1) // 2        # causal (query, key) pairs of one head
    wp, x, x32 = lm["wp"], lm["x"], lm["x32"]
    q, k, v = lm["q"], lm["k"], lm["v"]
    q32, k32, v32 = lm["q32"], lm["k32"], lm["v32"]
    n_scan = b * nc * H * P * N
    scan_bound = bound(ops_add((n_scan, {"fp32": 2})), 4 * (2 * n_scan + b * nc * H), n_sm,
                       clock_hz)
    w_bf16 = pow2_dequantize(wp, torch.bfloat16)
    w_f32 = pow2_dequantize(wp, torch.float32)
    # K7 bf16's like-for-like yardstick writes the kernel's float32 output
    # (aten::mm.dtype); where this torch refuses it, torch.matmul's bf16 output
    mm_lib, mm_lib_name = (lambda: torch.matmul(x, w_bf16)), "torch.matmul, bf16 output"
    matmul_ms = time_ms(mm_lib, reps=10)
    try:
        torch.mm(x[:8], w_bf16, out_dtype=torch.float32)
        mm_lib = lambda: torch.mm(x, w_bf16, out_dtype=torch.float32)   # noqa: E731
        mm_lib_name = "torch.mm out_dtype=float32"
        print(f"[numbers] K7 bf16 yardsticks: torch.mm(x, w, out_dtype=torch.float32) "
              f"{time_ms(mm_lib, reps=10):.4f} ms, torch.matmul (bf16 output) "
              f"{matmul_ms:.4f} ms; the library time below is torch.mm's; {smi}")
    except (RuntimeError, TypeError) as e:
        print(f"[numbers] K7 bf16 yardstick: torch.mm(..., out_dtype=torch.float32) raised "
              f"{type(e).__name__}: {str(e).splitlines()[0]}; the library time below is "
              f"torch.matmul's (bf16 output) {matmul_ms:.4f} ms; {smi}")
    yard = {"bf16": sdpa(q, k, v), "float32": sdpa(q32, k32, v32)}   # allow_tf32 False
    for dtype, (_, best, times, default_ms) in yard.items():
        print(f"[numbers] scaled_dot_product_attention {ATTN_SHAPE} {dtype}, causal, each "
              f"backend pinned: {', '.join(f'{n} {t:.4f} ms' for n, t in times.items())}; "
              f"unpinned {default_ms:.4f} ms; the library time below is {best}'s; {smi}")
    cases = {
        "ssd_state_scan": dict(
            shape=f"{SSD_SHAPE} float32 (mamba2-130m, batch 8 x 2048 tokens)",
            source="src/repro_torch/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:32",
            launch=ssd_state_scan_call(lm["state_c"], lm["decay"])[0], reps=50, replays=5,
            plain=lambda: ssd_state_scan_plain(lm["state_c"], lm["decay"]),
            library=None, bound=scan_bound),
        "pow2_matmul": dict(
            shape=f"x ({M}, {K}) bf16 x w ({K}, {Nf}) uint8 (qwen3-14b FFN)",
            source="src/repro_torch/csrc/pow2_matmul.cu",
            replaces="src/repro/kernels/pow2_matmul/kernel.py:54",
            launch=pow2_matmul_call(x, wp)[0], reps=10, replays=3,
            plain=lambda: pow2_matmul_plain(x, wp),
            library=mm_lib, library_name=mm_lib_name,
            bound=tc_bound(2 * M * K * Nf, TENSOR_BF16_FLOPS, 2 * M * K + K * Nf + 4 * M * Nf)),
        "pow2_matmul float32": dict(
            shape=f"x ({FFN_F32_M}, {K}) float32 x w ({K}, {Nf}) uint8",
            launch=pow2_matmul_call(x32, wp)[0], reps=10, replays=3,
            plain=lambda: pow2_matmul_plain(x32, wp),
            library=lambda: torch.matmul(x32, w_f32), library_name="torch.matmul",
            bound=tc_bound(2 * FFN_F32_M * K * Nf, FP32_FLOPS,
                           4 * FFN_F32_M * K + K * Nf + 4 * FFN_F32_M * Nf)),
        "flash_attention": dict(
            shape=f"{ATTN_SHAPE} bf16 (qwen3-14b prefill)",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:66",
            launch=flash_attention_call(q, k, v)[0], reps=20, replays=3,
            plain=lambda: flash_attention_plain(q, k, v),
            library=yard["bf16"][0],
            library_name=f"scaled_dot_product_attention, {yard['bf16'][1]}",
            bound=tc_bound(2 * BH * pairs * (D + Dv), TENSOR_BF16_FLOPS,
                           2 * BH * S * (2 * D + 2 * Dv), BH * pairs)),
        "flash_attention float32": dict(
            shape=f"{ATTN_SHAPE} float32",
            launch=flash_attention_call(q32, k32, v32)[0], reps=3, replays=2,
            plain=lambda: flash_attention_plain(q32, k32, v32),
            library=yard["float32"][0],
            library_name=f"scaled_dot_product_attention, {yard['float32'][1]}",
            bound=tc_bound(2 * BH * pairs * (D + Dv), FP32_FLOPS,
                           4 * BH * S * (2 * D + 2 * Dv), BH * pairs)),
    }
    rows = []
    for name, c in cases.items():
        ms = device_ms(c["launch"], reps=c["reps"], replays=c["replays"])
        plain_ms = time_ms(c["plain"], reps=3, warmup=1)
        lib_ms = time_ms(c["library"], reps=10) if c["library"] else None
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms ({c['library_name']})"
        bound_ms, bound_by, term = c["bound"]
        # the float32 cases run after the LM path's counts are read, as checks
        path = (f"{lm['launches'][name]} launch(es) through its op on the LM path"
                if name in lm["launches"] else "a check after the LM path")
        before = (f" (before its redesign {EARLIER_MS[name]:.4f} ms, quoted from PERF.md)"
                  if name in EARLIER_MS else "")
        print(f"[numbers] {name} {c['shape']}: kernel {ms:.4f} ms on the device{before} "
              f"({c['reps']} launches per graph x {c['replays']} replays); plain "
              f"{plain_ms:.3f} ms; library {lib}; bound {bound_ms:.4f} ms by "
              f"{bound_by} ({term}), {bound_ms / ms:.1%} of bound; {path}; {smi}")
        torch.cuda.empty_cache()
        row = {"max_abs_err": lm["err"][name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
        if "source" in c:
            rows.append({"name": name, "route": "cuda", "source": c["source"],
                         "replaces": c["replaces"], "launches": lm["launches"][name], **row})
        else:   # the float32 case of the row before it
            rows[-1]["float32"] = dict(row, launches=0)
    return rows


# -- the batched paths (lanes) ----------------------------------------------------

# the paper's suite (benchmarks/common.py: GA_POP 64, N_SEEDS 3), its 60
# generations cut to 20 for time; each dataset doped with its calibrated
# genomes and bounded by its bespoke baseline, from one float net shared by
# its seeds (benchmarks/common.py:_ga_setup)
SUITE_DATASETS = ("breast_cancer", "cardio", "pendigits", "redwine", "whitewine")
SUITE_POP, SUITE_SEEDS, SUITE_GENS = 64, (0, 1, 2), 20
GRID_POP, GRID_SEEDS, GRID_RATES, GRID_GENS = 256, (0, 1), (0.01, 0.02, 0.05), 10
GA_KERNELS = ("pop_mlp_correct", "pop_variation_kernel", "pop_generation_kernel",
              "pop_mlp_correct_mc", "pop_generation_kernel_mc")


def same(a, b) -> bool:
    """Bit-for-bit equality of two numpy arrays (float32 through int32)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


def require_state(what: str, got, want, pos=None, fields=FIELDS + CACHE):
    """Every listed GAState field of ``got`` equals ``want``'s. ``pos``: the
    unpadded positions of a padded cell, whose cache rows are gathered to
    the unpadded layout (their padding columns must be zero)."""
    from repro_torch.core.interop import state_to_numpy

    a, b = state_to_numpy(got), state_to_numpy(want)
    if pos is not None and "cache.rows" in a:
        rows = a["cache.rows"]
        if np.delete(rows, pos, axis=1).any():
            raise AssertionError(f"{what}: padding columns of the cache rows not zero")
        a["cache.rows"] = rows[:, pos]
    for f in fields:
        if not same(a[f], b[f]):
            raise AssertionError(f"{what}: GAState.{f} differs")


def counted(run):
    """``run()`` with every launch count set to 0 just before it; → (its
    result, the launches it made, its wall seconds)."""
    import torch
    from repro_torch.kernels import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {k: v for k, v in _cuda.LAUNCHES.items() if v}, wall


def require_launches(what: str, got: dict, want: dict):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want} (each kernel once "
                             f"per generation for all lanes)")


def suite_problems(dev, cfg, baselines: dict | None = None):
    """(dataset, Problem, doping genomes) of each suite dataset; with
    ``baselines`` each is bounded by its bespoke baseline's accuracy and
    doped with its calibrated genomes (:func:`paper_baseline`), else the
    1.0 baseline and no doping (the kernels' operands only)."""
    from repro_torch.core import engine
    from repro_torch.core.genome import MLPTopology
    from repro_torch.data import load_dataset

    out = []
    for name in SUITE_DATASETS:
        ds = load_dataset(name)
        base = paper_baseline(name, dev, baselines) if baselines is not None else None
        out.append((ds, engine.Problem.from_data(
            MLPTopology(ds.topology), ds.x_train, ds.y_train, cfg,
            baseline_acc=None if base is None else base["bb"].accuracy, device=dev),
            None if base is None else base["seeds"]))
    return out


def stacked_suite(problems, seeds):
    """The suite's lanes stacked as ``run_suite`` stacks them (one lane per
    (dataset, seed), unswept hyperparameters)."""
    from repro_torch.core import engine, sweep

    spec = sweep.suite_spec(problems)
    s_max = max(p.x_int.shape[0] for p in problems)
    return engine.stack_problems([sweep.pad_lane(p, spec, s_max) for p in problems
                                  for _ in seeds])


def suite_lanes(dev) -> dict:
    """The GA kernels' operands for the 15 lanes of the suite (padded
    layout, each lane its own samples): the stacked problem, its lane data,
    2P genomes a lane, K = 8 delta tables, the variation operands and the
    fitness keywords."""
    import torch
    from repro_torch.core import engine, prng
    from repro_torch.core.genome import _slot_keys, random_population

    cfg = engine.GAConfig(pop_size=SUITE_POP, generations=SUITE_GENS)
    stacked = stacked_suite([p for _, p, _ in suite_problems(dev, cfg)], SUITE_SEEDS)
    d = engine.lane_data(stacked)
    L, P = stacked.n_lanes, SUITE_POP
    pop = torch.stack([random_population(prng.PRNGKey(100 + i, dev), stacked.lane(i).genes,
                                         2 * P) for i in range(L)])
    deltas = torch.stack([engine.device_deltas(stacked.lane(i).replace_cfg(
        variation_mode="mean", n_device_samples=K_DEV)) for i in range(L)])
    t = d.genes
    keys = torch.stack([_slot_keys(prng.PRNGKey(200 + i, dev), (0, 1, 2)) for i in range(L)])
    gen = torch.Generator(device=dev).manual_seed(3)
    do = torch.rand((L, P), generator=gen, device=dev) < 0.7
    var = (pop[:, :P].contiguous(), pop[:, P:].contiguous(), do, t.low, t.high, t.is_mask,
           t.mask_bits, t.ids, keys, d.mutation_rate_gene)
    data = dict(spec=stacked.spec, n_valid_samples=d.n_valid_samples, out_mask=d.out_mask)
    return dict(stacked=stacked, d=d, pop=pop, deltas=deltas, var=var, data=data)


def lane_kernel_checks(dev) -> dict:
    """Phase 3 for the lane axis: each GA kernel launched once for the 15
    lanes of the suite (padded layout, each lane its own samples, a shared
    row bound below P) against its plain version, exactly."""
    import torch
    from repro_torch.kernels.pop_generation.kernel import (pop_generation_kernel,
                                                           pop_generation_plain)
    from repro_torch.kernels.pop_mlp.kernel import (pop_mlp_correct, pop_mlp_correct_mc,
                                                    pop_mlp_correct_mc_plain,
                                                    pop_mlp_correct_plain)
    from repro_torch.kernels.pop_variation.kernel import (pop_variation_kernel,
                                                          pop_variation_plain)

    lanes = suite_lanes(dev)
    stacked, d, pop, deltas, var, data = (lanes[k] for k in ("stacked", "d", "pop", "deltas",
                                                             "var", "data"))
    L, P, t = stacked.n_lanes, SUITE_POP, d.genes
    err = {}
    for rows in (2 * P, 77):
        n = torch.tensor(rows, dtype=torch.int32, device=dev)
        err["pop_mlp_correct"] = require_equal(
            f"lane pop_mlp_correct rows={rows}",
            pop_mlp_correct(pop, d.x, d.labels, n_valid_rows=n, **data),
            pop_mlp_correct_plain(pop, d.x, d.labels, n_valid_rows=n, **data))
        err["pop_mlp_correct_mc"] = require_equal(
            f"lane pop_mlp_correct_mc rows={rows}",
            pop_mlp_correct_mc(pop, d.x, d.labels, deltas, t.high, n_valid_rows=n, **data),
            pop_mlp_correct_mc_plain(pop, d.x, d.labels, dev=deltas, gene_high=t.high,
                                     n_valid_rows=n, **data))
    err["pop_variation_kernel"] = require_equal(
        "lane pop_variation_kernel", pop_variation_kernel(*var), pop_variation_plain(*var))
    for name, dv in (("pop_generation_kernel", None), ("pop_generation_kernel_mc", deltas)):
        ch, cnt = pop_generation_kernel(*var, d.x, d.labels, dev=dv, **data)
        ch_p, cnt_p = pop_generation_plain(*var, d.x, d.labels, dev=dv, **data)
        err[name] = max(require_equal(f"lane {name} children", ch, ch_p),
                        require_equal(f"lane {name} counts", cnt, cnt_p))
    samp = d.n_valid_samples.tolist()
    print(f"[kernels] lane axis: {L} lanes of the suite (padded topology "
          f"{stacked.spec.topo.sizes}, G={stacked.spec.n_genes}, S={d.x.shape[1]} padded, own "
          f"samples {sorted(set(samp))}), P={P}, K={K_DEV}: pop_mlp_correct and "
          f"pop_mlp_correct_mc (rows {2 * P} and 77), pop_variation_kernel, "
          f"pop_generation_kernel and its n_dev branch, one launch each for all lanes, equal "
          f"their plain versions")
    return dict(lanes, err=err, samp=samp)


def batched_paths(dev, baselines: dict) -> dict:
    """Phase 4b: the batched entry points, each path with the launch counts
    set to 0 just before it and read just after; every cell against its
    sequential ``GATrainer.run`` on the card, bit for bit."""
    import dataclasses

    import torch
    from repro_torch.core import GATrainer, engine, sweep
    from repro_torch.core.genome import MLPTopology
    from repro_torch.data import load_dataset
    from repro_torch.kernels.backend import BackendPolicy

    launches, out = {}, {}
    # -- the paper's suite, 5 datasets x 3 seeds = 15 lanes, generation "auto"
    cfg = engine.GAConfig(pop_size=SUITE_POP, generations=SUITE_GENS)
    items = suite_problems(dev, cfg, baselines)
    res, launches["suite"], wall = counted(lambda: sweep.run_suite(
        [p for _, p, _ in items], SUITE_SEEDS, doping_seeds=[dp for _, _, dp in items],
        names=list(SUITE_DATASETS)))
    require_launches("suite", launches["suite"],
                     {"pop_mlp_correct": 1, "pop_generation_kernel": SUITE_GENS})
    t0 = time.perf_counter()
    for i in range(res.n_cells):
        ds, _, dope = items[res.dataset_of(i)]
        tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                       dataclasses.replace(cfg, seed=res.cell(i)["seed"]),
                       baseline_acc=baselines[ds.name]["bb"].accuracy,
                       doping_seeds=dope, device=dev)
        st, _ = tr.run()
        require_state(f"suite cell {res.cell(i)}", res.state_at(i), st,
                      pos=res.positions[res.dataset_of(i)])
        if (res.unique_evals(i), res.cache_hits(i)) != (tr.unique_evals, tr.cache_hits):
            raise AssertionError(f"suite cell {res.cell(i)}: unique_evals/cache_hits differ")
    seq = time.perf_counter() - t0
    feasible = [int((res.state_at(i).viol <= 0).sum()) for i in range(res.n_cells)]
    print(f"[batch] run_suite {SUITE_DATASETS} x seeds {SUITE_SEEDS} = {res.n_cells} lanes, "
          f"pop {SUITE_POP}, {SUITE_GENS} generations, generation auto, doped with each "
          f"dataset's {len(items[0][2])} calibrated genomes, bespoke baselines "
          f"{[round(baselines[n]['bb'].accuracy, 4) for n in SUITE_DATASETS]}: {wall:.2f} s batched vs "
          f"{seq:.2f} s for the {res.n_cells} sequential GATrainer runs; launches "
          f"{launches['suite']}; feasible survivors per lane {feasible}; every cell equals "
          f"its unpadded sequential run (all fields, cache, unique_evals, cache_hits)")
    out["suite"] = res
    # -- run_grid at pendigits width, generation backends ref and phases
    ds = load_dataset("pendigits")
    topo = MLPTopology(ds.topology)
    for backend in ("ref", "phases"):
        gcfg = engine.GAConfig(pop_size=GRID_POP, generations=GRID_GENS,
                               backends=BackendPolicy(generation=backend))
        prob = engine.Problem.from_data(topo, ds.x_train, ds.y_train, gcfg, device=dev)
        grid, launches[f"grid {backend}"], wall = counted(lambda: sweep.run_grid(
            prob, GRID_SEEDS, mutation_rates=GRID_RATES))
        require_launches(f"grid {backend}", launches[f"grid {backend}"],
                         {"pop_mlp_correct": GRID_GENS + 1, "pop_variation_kernel": GRID_GENS})
        for i in range(grid.n_cells):
            c = grid.cell(i)
            tr = GATrainer(topo, ds.x_train, ds.y_train, dataclasses.replace(
                gcfg, seed=c["seed"], mutation_rate_gene=c["mutation_rate_gene"]), device=dev)
            st, _ = tr.run()
            require_state(f"grid {backend} cell {c}", grid.state_at(i), st)
            if (grid.unique_evals(i), grid.cache_hits(i)) != (tr.unique_evals, tr.cache_hits):
                raise AssertionError(f"grid {backend} cell {c}: unique_evals/cache_hits differ")
        print(f"[batch] run_grid pendigits pop {GRID_POP}, seeds {GRID_SEEDS} x mutation rates "
              f"{GRID_RATES} = {grid.n_cells} lanes, {GRID_GENS} generations, generation "
              f"{backend}: {wall:.2f} s; launches {launches[f'grid {backend}']}; every cell "
              f"equals its sequential run (all fields, cache, unique_evals, cache_hits)")
    # -- run_batch on the device-variation path
    mcfg = engine.GAConfig(pop_size=GRID_POP, generations=GRID_GENS, variation_mode="mean",
                           n_device_samples=K_DEV)
    prob = engine.Problem.from_data(topo, ds.x_train, ds.y_train, mcfg, device=dev)
    (states, aux, n0), launches["batch mc"], wall = counted(
        lambda: engine.run_batch(prob, [0, 1]))
    require_launches("batch mc", launches["batch mc"],
                     {"pop_mlp_correct_mc": 1, "pop_generation_kernel_mc": GRID_GENS})
    for i, seed in enumerate((0, 1)):
        tr = GATrainer(topo, ds.x_train, ds.y_train, dataclasses.replace(mcfg, seed=seed),
                       device=dev)
        st, _ = tr.run()
        require_state(f"batch mc seed {seed}", engine.state_at(states, i), st)
        if int(n0[i]) + int(aux[2][i].sum()) != tr.unique_evals:
            raise AssertionError(f"batch mc seed {seed}: unique_evals differ")
    print(f"[batch] run_batch pendigits pop {GRID_POP}, seeds [0, 1], {GRID_GENS} generations, "
          f"variation_mode=mean K={K_DEV}, generation auto: {wall:.2f} s; launches "
          f"{launches['batch mc']}; each run equals its sequential run")
    # -- across devices: a small doped suite on the card against the CPU
    small = engine.GAConfig(pop_size=16, generations=4)
    runs = {}
    for d in (dev, "cpu"):
        probs = [engine.Problem.from_data(MLPTopology(x.topology), x.x_train, x.y_train, small,
                                          baseline_acc=baselines[x.name]["bb"].accuracy, device=d)
                 for x in (load_dataset("breast_cancer"), load_dataset("redwine"))]
        runs[str(d)] = sweep.run_suite(probs, [0, 1], doping_seeds=[
            baselines[n]["seeds"] for n in ("breast_cancer", "redwine")])
    a, b = runs[str(dev)], runs["cpu"]
    for i in range(a.n_cells):     # auto: kernel path on the card, ref on the CPU
        require_state(f"small suite cell {i} card vs CPU", a.state_at(i), b.state_at(i),
                      fields=FIELDS)
    if not all(same(a.aux[k].cpu(), b.aux[k]) for k in (0, 1)) or not same(
            a.init_evals.cpu(), b.init_evals):
        raise AssertionError("small suite: best objectives or init evals differ card vs CPU")
    print("[batch] run_suite breast_cancer + redwine, pop 16, 4 generations, doped, bespoke "
          "baselines: card (kernels) == CPU (plain paths), bit for bit")
    # -- EvalCache hits on the card (generation "ref"), against the CPU
    bc = load_dataset("breast_cancer")
    hcfg = engine.GAConfig(pop_size=64, generations=20, mutation_rate_gene=0.005, seed=0,
                           backends=BackendPolicy(generation="ref"))
    hit = {}
    for d in (dev, "cpu"):
        tr = GATrainer(MLPTopology(bc.topology), bc.x_train, bc.y_train, hcfg, device=d)
        hit[str(d)] = (tr.run()[0], tr.cache_hits, tr.unique_evals)
    require_state("cache hits card vs CPU", hit[str(dev)][0], hit["cpu"][0])
    if hit[str(dev)][1:] != hit["cpu"][1:] or hit["cpu"][1] <= 0:
        raise AssertionError(f"cache hits/unique evals: card {hit[str(dev)][1:]}, CPU "
                             f"{hit['cpu'][1:]} (must be equal, hits > 0)")
    print(f"[batch] EvalCache hits on the card: breast_cancer pop 64, 20 generations, "
          f"mutation 0.005, generation ref: cache_hits {hit['cpu'][1]}, unique_evals "
          f"{hit['cpu'][2]}, every field and the cache equal the CPU run")
    out["launches"] = launches
    return out


# -- the paper's pipeline ------------------------------------------------------

# float training as benchmarks/common.py:_float_baseline runs it (800 steps,
# 3 restarts, seed 0); the doped GA at the e2e phase's pendigits pop 256
FLOAT_STEPS, FLOAT_RESTARTS, FLOAT_SEED = 800, 3, 0
PIPE_POP, PIPE_GENS, MAX_LOSS = 256, GENERATIONS, 0.05
# the card's float training against the CPU's from the same CPU-drawn
# weights: float32 sums run in other orders on the two devices, so a sample
# at the decision boundary may flip; 0.002 is 15 of pendigits' 7696 rows
# (the port against the reference on the CPU: equal, tests/test_torch_baselines.py)
TRAIN_ACC_TOL = 0.002


def paper_baseline(name: str, dev, made: dict) -> dict:
    """One dataset's float net, exact bespoke baseline and calibrated
    doping genomes on the card (``benchmarks/common.py:_ga_setup``), made
    once into ``made`` and shared by every phase that needs them."""
    if name not in made:
        import torch
        from repro_torch.core import (GenomeSpec, MLPTopology, calibrated_seeds,
                                      exact_bespoke_baseline, train_float_mlp)
        from repro_torch.data import load_dataset

        ds = load_dataset(name)
        topo = MLPTopology(ds.topology)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fm = train_float_mlp(topo, ds.x_train, ds.y_train, ds.x_test, ds.y_test,
                             steps=FLOAT_STEPS, restarts=FLOAT_RESTARTS, seed=FLOAT_SEED,
                             device=dev)
        train_s = time.perf_counter() - t0
        bb = exact_bespoke_baseline(topo, fm, ds.x_test, ds.y_test, device=dev)
        seeds = calibrated_seeds(GenomeSpec(topo), fm, ds.x_train, device=dev)
        made[name] = dict(ds=ds, topo=topo, fm=fm, train_s=train_s, bb=bb, seeds=seeds)
    return made[name]


def paper_pipeline(dev, smi: str, baselines: dict) -> dict:
    """Phase 4d: the paper's pipeline at pendigits (16, 5, 10) on the card
    (``examples/quickstart.py``): float training, the exact bespoke
    baseline, calibrated doping, the doped GA under generation auto and
    phases, the design within 5 % loss, the post-training approximation,
    Verilog. Each step is held against the CPU or against the card's other
    path; the GA runs and the post-training loop are counted paths."""
    import torch
    from repro_torch.core import (GAConfig, GATrainer, GenomeSpec, HardwareCost,
                                  best_within_loss, calibrated_seeds, emit_verilog,
                                  evaluate_genome_python, exact_bespoke_baseline,
                                  mlp_predict, post_training_approx, quantize_inputs,
                                  train_float_mlp)
    from repro_torch.kernels.backend import BackendPolicy
    from repro_torch.kernels.pop_mlp import population_correct

    base = paper_baseline("pendigits", dev, baselines)
    ds, topo, fm, bb, seeds = (base[k] for k in ("ds", "topo", "fm", "bb", "seeds"))
    spec = GenomeSpec(topo)
    out = {"launches": {}}
    # 1. float training, on the card and on the CPU from the same weights
    t0 = time.perf_counter()
    fm_cpu = train_float_mlp(topo, ds.x_train, ds.y_train, ds.x_test, ds.y_test,
                             steps=FLOAT_STEPS, restarts=FLOAT_RESTARTS, seed=FLOAT_SEED,
                             device="cpu")
    cpu_s = time.perf_counter() - t0
    gap = abs(fm.train_acc - fm_cpu.train_acc)
    if not gap <= TRAIN_ACC_TOL:
        raise AssertionError(f"pipeline: float train accuracy card {fm.train_acc} vs CPU "
                             f"{fm_cpu.train_acc} (tolerance {TRAIN_ACC_TOL})")
    weight_gap = max(float(np.abs(a - b).max()) for a, b in zip(fm.weights, fm_cpu.weights))
    print(f"[pipeline] pendigits {topo.sizes}: train_float_mlp {FLOAT_STEPS} steps x "
          f"{FLOAT_RESTARTS} restarts on the card {base['train_s']:.2f} s wall (CPU "
          f"{cpu_s:.2f} s); train accuracy {fm.train_acc:.6f} (CPU {fm_cpu.train_acc:.6f}, "
          f"|gap| {gap:.6f} <= {TRAIN_ACC_TOL}), test accuracy {fm.test_acc:.6f} (CPU "
          f"{fm_cpu.test_acc:.6f}); largest weight difference {weight_gap:.3g}; {smi}")
    # 2. the exact bespoke baseline and the calibrated genomes, card vs CPU
    bb_cpu = exact_bespoke_baseline(topo, fm, ds.x_test, ds.y_test, device="cpu")
    if (bb.accuracy, bb.fa_count) != (bb_cpu.accuracy, bb_cpu.fa_count) or not all(
            same(a, b) for a, b in zip(bb.weights_q + bb.biases_q,
                                       bb_cpu.weights_q + bb_cpu.biases_q)):
        raise AssertionError("pipeline: the bespoke baseline differs between card and CPU")
    seeds_cpu = calibrated_seeds(spec, fm, ds.x_train, device="cpu")
    if len(seeds) != len(seeds_cpu) or not all(same(a, b) for a, b in zip(seeds, seeds_cpu)):
        raise AssertionError("pipeline: the calibrated genomes differ between card and CPU")
    cost = HardwareCost.from_fa(bb.fa_count)
    print(f"[pipeline] exact bespoke baseline: test accuracy {bb.accuracy:.6f}, "
          f"{bb.fa_count} FA ({cost.area_cm2:.2f} cm2, {cost.power_mw:.2f} mW); "
          f"{len(seeds)} calibrated genomes; both equal the CPU's bit for bit")
    # 3. the doped GA, generation auto and phases
    finals = {}
    for backend in ("auto", "phases"):
        cfg = GAConfig(pop_size=PIPE_POP, generations=PIPE_GENS, seed=0,
                       backends=BackendPolicy(generation=backend))
        tr = GATrainer(topo, ds.x_train, ds.y_train, cfg, baseline_acc=bb.accuracy,
                       doping_seeds=seeds, device=dev)
        (state, _), out["launches"][f"ga {backend}"], wall = counted(tr.run)
        obj = state.obj.cpu().numpy()
        pop = state.pop.cpu().numpy()
        if not (np.isfinite(obj).all() and obj.shape == (PIPE_POP, 2)
                and (pop >= spec.low).all() and (pop < spec.high).all()):
            raise AssertionError(f"pipeline GA {backend}: objectives or genomes out of shape")
        finals[backend] = (tr, state)
        print(f"[pipeline] GATrainer pendigits pop {PIPE_POP} gens {PIPE_GENS}, baseline_acc "
              f"{bb.accuracy:.6f}, doped, generation {backend}: {wall:.2f} s wall; "
              f"feasible {int((state.viol <= 0).sum())}; launches "
              f"{out['launches'][f'ga {backend}']}")
    require_state("pipeline GA auto vs phases", finals["phases"][1], finals["auto"][1])
    require_launches("pipeline GA auto", out["launches"]["ga auto"],
                     {"pop_mlp_correct": 1, "pop_generation_kernel": PIPE_GENS})
    require_launches("pipeline GA phases", out["launches"]["ga phases"],
                     {"pop_mlp_correct": PIPE_GENS + 1, "pop_variation_kernel": PIPE_GENS})
    # 4. the design within 5 % of the baseline (else the front's most accurate)
    tr, state = finals["auto"]
    front = tr.front(state)
    idx = best_within_loss(front["objectives"], 1 - bb.accuracy, MAX_LOSS)
    pick = idx if idx is not None else int(np.argmin(front["objectives"][:, 0]))
    genome = front["genomes"][pick]
    err, fa = (float(v) for v in front["objectives"][pick])
    print(f"[pipeline] front of {len(front['objectives'])} points; "
          + (f"best within {MAX_LOSS:.0%} loss: " if idx is not None else
             f"none within {MAX_LOSS:.0%} loss of the baseline, the most accurate: ")
          + f"train error {err:.6f}, {fa:.0f} FA ({bb.fa_count / max(fa, 1):.1f}x smaller)")
    # 5. the post-training approximation, card vs CPU
    pt, out["launches"]["post-training"], pt_s = counted(lambda: post_training_approx(
        spec, fm, ds.x_train, ds.y_train, max_loss=MAX_LOSS, baseline_acc=bb.accuracy,
        device=dev))
    t0 = time.perf_counter()
    pt_cpu = post_training_approx(spec, fm, ds.x_train, ds.y_train, max_loss=MAX_LOSS,
                                  baseline_acc=bb.accuracy, device="cpu")
    pt_cpu_s = time.perf_counter() - t0
    if not (same(pt[0], pt_cpu[0]) and pt[1:] == pt_cpu[1:]):
        raise AssertionError(f"pipeline: post_training_approx card {pt[1:]} vs CPU "
                             f"{pt_cpu[1:]} (genome equal: {same(pt[0], pt_cpu[0])})")
    k1 = out["launches"]["post-training"]
    if set(k1) != {"pop_mlp_correct"}:
        raise AssertionError(f"pipeline: post_training_approx launched {k1}")
    out["post_training"] = dict(s=pt_s, cpu_s=pt_cpu_s, launches=k1["pop_mlp_correct"],
                                acc=pt[1], fa=pt[2])
    print(f"[pipeline] post_training_approx (max loss {MAX_LOSS}): train accuracy "
          f"{pt[1]:.6f}, {pt[2]} FA; {pt_s:.3f} s wall on the card with "
          f"{k1['pop_mlp_correct']} pop_mlp_correct launches ({pt_s / k1['pop_mlp_correct'] * 1e3:.3f} "
          f"ms a trial, each a host read), {pt_cpu_s:.2f} s on the CPU; genome, accuracy "
          f"and FA equal the CPU's; {smi}")
    # 6. Verilog: the circuit's simulated predictions against the card's
    verilog = emit_verilog(spec, genome, name="pendigits_mlp")
    x = torch.as_tensor(np.asarray(ds.x_test, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(ds.y_test), device=dev).to(torch.int32)
    x_int = quantize_inputs(x, topo.input_bits)
    sim = evaluate_genome_python(spec, genome, x_int.cpu().numpy()).argmax(axis=-1)
    g = torch.as_tensor(genome, device=dev)
    pred = mlp_predict(spec, g, x).cpu().numpy()
    if not np.array_equal(sim, pred):
        raise AssertionError("pipeline: the circuit's predictions differ from mlp_predict's")
    count, out["launches"]["verilog check"], _ = counted(
        lambda: int(population_correct(g[None], x_int, y, spec=spec)[0]))
    sim_count = int((sim == ds.y_test).sum())
    if sim_count != count or out["launches"]["verilog check"] != {"pop_mlp_correct": 1}:
        raise AssertionError(f"pipeline: the circuit counts {sim_count} correct, K1 {count}")
    print(f"[pipeline] emit_verilog: {len(verilog.splitlines())} lines, {len(verilog)} bytes; "
          f"evaluate_genome_python on the {len(sim)} test rows equals mlp_predict on the card, "
          f"{sim_count} correct, equal to K1's count (test accuracy "
          f"{sim_count / len(sim):.6f})")
    return out


# -- the islands ---------------------------------------------------------------

# the island path at the e2e phase's pendigits width: 16 islands of 64 rows
# (IslandConfig's island_pop), migrate_every 10 and n_migrants 4 (its
# defaults), 3 of its 10 rounds
ISLANDS, ISLAND_POP, ISLAND_EVERY, ISLAND_MIGRANTS, ISLAND_ROUNDS = 16, 64, 10, 4, 3
CARRY = ("pop", "obj", "viol", "counts", "rank", "crowd", "key",
         "cache.rows", "cache.vals", "cache.stamp")
# the small breast_cancer rings tests/test_torch_islands.py holds against the
# reference's shard_map islands: island_pop 16, migrate_every 3, n_migrants
# 2, 3 rounds
SMALL_RING = dict(island_pop=16, migrate_every=3, n_migrants=2, rounds=3)
SMALL_RINGS = {
    "data4_dedup_off": dict(mesh=(4,), axes=("data",), ga=dict(dedup=False), seed=3,
                            baseline=1.0, dope=False),
    "data4_dedup_on": dict(mesh=(4,), axes=("data",), ga=dict(dedup=True), seed=3,
                           baseline=1.0, dope=False),
    "data4_mean": dict(mesh=(4,), axes=("data",),
                       ga=dict(variation_mode="mean", n_device_samples=3), seed=5,
                       baseline=0.9, dope=False),
    "pod2_data2": dict(mesh=(2, 2), axes=("pod", "data"), ga=dict(), seed=7,
                       baseline=0.9, dope=True),
}


def island_rounds(ds, icfg, mesh, axes, baseline, seed, dope=None, timed=False):
    """``build_island_step`` on ``mesh``: the carry after init and after
    each round (on the mesh's device), and each round's wall seconds."""
    import torch
    from repro_torch.core import GenomeSpec, MLPTopology, build_island_step, quantize_inputs

    topo = MLPTopology(ds.topology)
    x = torch.as_tensor(ds.x_train, dtype=torch.float32, device=mesh.device)
    init, round_fn = build_island_step(GenomeSpec(topo), icfg, mesh,
                                       quantize_inputs(x, topo.input_bits), ds.y_train,
                                       baseline, axes)
    carries, walls = [init(seed, dope)], []
    for _ in range(icfg.rounds):
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        carries.append(round_fn(*carries[-1]))
        if timed:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return carries, walls


def require_carry(what: str, got, want):
    """Every leaf of two island carries equal, bit for bit."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} carry leaves against {len(want)}")
    for name, a, b in zip(CARRY, got, want):
        if not same(a.cpu().numpy(), b.cpu().numpy()):
            raise AssertionError(f"{what}: carry leaf {name} differs")


def island_paths(dev, smi: str) -> dict:
    """Phase 4e: island-parallel NSGA-II on a one-card mesh, each path with
    the launch counts set to 0 just before it and read just after: one
    island equals ``GATrainer.run``; 16 islands at pendigits width under
    generation auto and phases, bit-identical, each kernel launched once
    per generation for all islands; the small breast_cancer rings on the
    card equal the CPU's every round; the wall time per round and per
    generation and the ranking's share."""
    import numpy as np
    import torch
    from repro_torch.core import (GAConfig, GATrainer, GenomeSpec, IslandConfig,
                                  MLPTopology, build_island_step, quantize_inputs)
    from repro_torch.core.interop import state_to_numpy
    from repro_torch.data import load_dataset
    from repro_torch.kernels.backend import BackendPolicy
    from repro_torch.kernels.pop_generation import ref as gen_ref
    from repro_torch.launch import make_mesh

    launches = {}
    ds = load_dataset("pendigits")
    topo = MLPTopology(ds.topology)
    # (i) one island is a GATrainer run: pop 256, 20 generations in 1 round
    cfg = GAConfig(pop_size=256, generations=GENERATIONS, seed=0)
    one = make_mesh((1,), ("data",), device=dev)
    icfg = IslandConfig(ga=cfg, island_pop=256, migrate_every=GENERATIONS, n_migrants=4,
                        rounds=1)
    (carries, _), launches["one island"], wall = counted(
        lambda: island_rounds(ds, icfg, one, ("data",), 1.0, cfg.seed))
    require_launches("one island", launches["one island"],
                     {"pop_mlp_correct": 1, "pop_generation_kernel": GENERATIONS})
    tr = GATrainer(topo, ds.x_train, ds.y_train, cfg, device=dev)
    want = state_to_numpy(tr.run()[0])
    for name, leaf in zip(CARRY, carries[-1]):
        leaf = leaf[0] if name == "key" else leaf       # the one island's key
        if not same(leaf.cpu().numpy().astype(want[name].dtype), want[name]):
            raise AssertionError(f"one island vs GATrainer.run: {name} differs")
    print(f"[islands] pendigits 1 island x pop 256, {GENERATIONS} generations in 1 round, "
          f"generation auto: {wall:.2f} s; launches {launches['one island']}; every carry "
          f"leaf (cache included) equals GATrainer.run's final state")

    # (ii) 16 islands at pendigits width, generation auto and phases
    mesh = make_mesh((ISLANDS,), ("data",), device=dev)
    gens = ISLAND_ROUNDS * ISLAND_EVERY
    finals = {}
    for backend, want_launches in (
            ("auto", {"pop_mlp_correct": 1, "pop_generation_kernel": gens}),
            ("phases", {"pop_mlp_correct": gens + 1, "pop_variation_kernel": gens})):
        icfg = IslandConfig(ga=GAConfig(seed=0, backends=BackendPolicy(generation=backend)),
                            island_pop=ISLAND_POP, migrate_every=ISLAND_EVERY,
                            n_migrants=ISLAND_MIGRANTS, rounds=ISLAND_ROUNDS)
        (carries, walls), launches[f"islands {backend}"], wall = counted(
            lambda icfg=icfg: island_rounds(ds, icfg, mesh, ("data",), 1.0, 0, timed=True))
        require_launches(f"islands {backend}", launches[f"islands {backend}"], want_launches)
        finals[backend] = carries[-1]
        pop, obj = carries[-1][0].cpu().numpy(), carries[-1][1].cpu().numpy()
        spec = GenomeSpec(topo)
        if not (np.isfinite(obj).all() and obj.shape == (ISLANDS * ISLAND_POP, 2)
                and ((pop >= spec.low) & (pop < spec.high)).all()):
            raise AssertionError(f"islands {backend}: objectives or genomes out of shape")
        print(f"[islands] pendigits {ISLANDS} islands x pop {ISLAND_POP}, {ISLAND_ROUNDS} "
              f"rounds x {ISLAND_EVERY} generations, {ISLAND_MIGRANTS} migrants, generation "
              f"{backend}: {wall:.2f} s with init; rounds "
              f"{[round(w, 3) for w in walls]} s, {sum(walls) / gens * 1e3:.2f} ms per "
              f"generation; launches {launches[f'islands {backend}']}; {smi}")
    require_carry("islands auto vs phases", finals["phases"], finals["auto"])
    # from the final carry, through round_fn: a round of one generation, and a
    # round of none (the ring's migration and re-rank, with the carry's
    # repacking); the generation's ranking is the 16 lanes' rank_select_rerank
    # on the pools that generation ranked (parents plus children), captured
    # in an untimed call; host clock between CUDA events
    xq = quantize_inputs(torch.as_tensor(ds.x_train, dtype=torch.float32, device=dev),
                         topo.input_bits)
    step = {every: build_island_step(
        GenomeSpec(topo), IslandConfig(ga=GAConfig(seed=0, backends=BackendPolicy(
            generation="auto")), island_pop=ISLAND_POP, migrate_every=every,
            n_migrants=ISLAND_MIGRANTS, rounds=1), mesh, xq, ds.y_train, 1.0)[1]
        for every in (1, 0)}
    pools, rank_pool = [], gen_ref.rank_select_rerank

    def capture(obj, viol, mu, **kw):
        pools.append((obj, viol, mu, kw))
        return rank_pool(obj, viol, mu, **kw)

    gen_ref.rank_select_rerank = capture
    try:
        step[1](*finals["auto"])
    finally:
        gen_ref.rank_select_rerank = rank_pool
    if len(pools) != ISLANDS or any(o.shape[0] != 2 * ISLAND_POP for o, *_ in pools):
        raise AssertionError(f"islands: the generation ranked {len(pools)} pools, not "
                             f"{ISLANDS} of {2 * ISLAND_POP} rows")
    round_ms = time_ms(lambda: step[1](*finals["auto"]), reps=3, warmup=1)
    migrate_ms = time_ms(lambda: step[0](*finals["auto"]), reps=3, warmup=1)
    rank_ms = time_ms(lambda: [rank_pool(o, v, mu, **kw) for o, v, mu, kw in pools],
                      reps=3, warmup=1)
    gen_ms = round_ms - migrate_ms
    print(f"[islands] a round of one generation of the {ISLANDS} islands (generation "
          f"auto): {round_ms:.2f} ms; a round of none (the ring's migration and re-rank): "
          f"{migrate_ms:.2f} ms; so one batched generation {gen_ms:.2f} ms, of which the "
          f"{ISLANDS} lanes' rank_select_rerank on that generation's pools of "
          f"{2 * ISLAND_POP} rows (parents plus children) {rank_ms:.2f} ms "
          f"({rank_ms / gen_ms:.0%}); {smi}")

    # (iii) the small breast_cancer rings on the card against the CPU, every
    # round: K1/K3 nominal, K4/K3 n_dev under variation_mode="mean"
    bc = load_dataset("breast_cancer")
    bspec = GenomeSpec(MLPTopology(bc.topology))
    dope = np.stack([np.asarray(bspec.high) - 1, np.asarray(bspec.low)]).astype(np.int32)
    for name, c in SMALL_RINGS.items():
        icfg = IslandConfig(ga=GAConfig(**c["ga"]), **SMALL_RING)
        runs = {}
        for d in (dev, "cpu"):
            mesh = make_mesh(c["mesh"], c["axes"], device=d)

            def run(icfg=icfg, mesh=mesh, c=c):
                return island_rounds(bc, icfg, mesh, c["axes"], c["baseline"], c["seed"],
                                     dope if c["dope"] else None)

            if d == dev:
                (runs[d], _), launches[f"ring {name}"], _ = counted(run)
            else:
                runs[d], _ = run()
        gens = SMALL_RING["rounds"] * SMALL_RING["migrate_every"]
        want = ({"pop_mlp_correct_mc": 1, "pop_generation_kernel_mc": gens}
                if c["ga"].get("variation_mode") else
                {"pop_mlp_correct": 1, "pop_generation_kernel": gens})
        require_launches(f"ring {name}", launches[f"ring {name}"], want)
        # generation auto is the kernel path on the card, which carries the
        # EvalCache through as init left it, and "ref" on the CPU, which
        # updates it: every other leaf must agree
        for r, (a, b) in enumerate(zip(runs[dev], runs["cpu"])):
            require_carry(f"ring {name} round {r} card vs CPU", a[:7], b[:7])
        print(f"[islands] breast_cancer ring {name} (mesh {c['mesh']} {c['axes']}, "
              f"{c['ga']}): card (kernels) == CPU (plain paths) after init and each of "
              f"{SMALL_RING['rounds']} rounds, every carry leaf but the EvalCache; launches "
              f"{launches[f'ring {name}']}")
    union = {k for got in launches.values() for k, v in got.items() if v}
    missing = set(GA_KERNELS) - union
    if missing:
        raise AssertionError(f"islands: kernels never launched on the path: {missing}")
    return launches


# -- the search server -----------------------------------------------------------

# the paper's suite as a stream of jobs: each dataset once and three more
# seeds of the two largest (pendigits, cardio), budgets 5 to 20 generations,
# served on 4 lanes in segments of 5 generations, longest budget first; the
# last two segments run 2 and then 1 of the 4 lanes, so the stream shows
# empty lanes left out of K3's launches
SERVE_LANES, SERVE_SEGMENT, SERVE_POLICY = 4, 5, "longest"
SERVE_JOBS = (("breast_cancer", 0, 20), ("cardio", 0, 20), ("pendigits", 0, 20),
              ("redwine", 0, 5), ("whitewine", 0, 20), ("pendigits", 1, 10),
              ("pendigits", 2, 5), ("cardio", 1, 15))
# the device-variation stream: 2 lanes at breast_cancer and redwine
SERVE_MC_JOBS = (("breast_cancer", 0, 10), ("redwine", 0, 5), ("redwine", 1, 10))


def generations_with_work(results, segment_len: int) -> int:
    """The generations of a stream in which some lane was active: a job
    admitted at segment a with budget b is active in generations
    [a * segment_len, a * segment_len + b) of the stream."""
    busy = set()
    for r in results:
        start = r.admitted_segment * segment_len
        busy.update(range(start, start + r.generations))
    return len(busy)


@contextlib.contextmanager
def k3_lanes_recorded():
    """Record the lane count of every K3 launch made inside, one entry a
    launch."""
    from repro_torch.kernels.pop_generation import ops as gen_ops

    lanes, launch_k3 = [], gen_ops.pop_generation_kernel

    def k3(a_rows, *args, **kw):
        lanes.append(a_rows.shape[0] if a_rows.dim() == 3 else 1)
        return launch_k3(a_rows, *args, **kw)

    gen_ops.pop_generation_kernel = k3
    try:
        yield lanes
    finally:
        gen_ops.pop_generation_kernel = launch_k3


def serve_job(name: str, seed: int, budget: int, problems: dict):
    """The stream's job for ``name``'s problem, doped as the stream dopes
    it, named ``name/seed``."""
    from repro_torch.serve import SearchJob

    _, prob, dope = problems[name]
    return SearchJob(prob, budget, seed=seed, doping_seeds=dope, name=f"{name}/{seed}")


def serve_stream(srv, problems: dict, jobs, validate: bool = False):
    """Submit ``jobs`` ((dataset, seed, budget)) to ``srv`` and step until it
    drains; → (results by job id, the jobs by id, each step's wall seconds,
    the lanes of every K3 launch). With ``validate`` every busy lane must
    pass ``engine.validate_state`` at every segment boundary (untimed)."""
    import torch
    from repro_torch.core import engine

    by_id = {srv.submit(serve_job(name, seed, budget, problems)): (name, seed, budget)
             for name, seed, budget in jobs}
    results, walls = {}, []
    with k3_lanes_recorded() as k3_lanes:
        while srv.has_work:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = srv.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            results.update((r.job_id, r) for r in done)
            for lane in srv.active_jobs if validate else ():
                flags = engine.validate_state(srv.lane_problem(lane), srv.lane_state(lane))
                if not bool(flags.all()):
                    raise AssertionError(f"serve: lane {lane} fails validate_state "
                                         f"{flags.tolist()} at segment {srv.segments_done}")
    return results, by_id, walls, k3_lanes


def require_trainer_parity(what: str, results: dict, by_id: dict, problems: dict, cfg, dev,
                           baselines: dict):
    """Every retired job equals its standalone ``GATrainer.run`` on the card:
    every state field, ``unique_evals`` and ``cache_hits``."""
    import dataclasses

    from repro_torch.core import GATrainer, MLPTopology

    for jid, r in results.items():
        name, seed, budget = by_id[jid]
        ds, _, dope = problems[name]
        tr = GATrainer(MLPTopology(ds.topology), ds.x_train, ds.y_train,
                       dataclasses.replace(cfg, seed=seed, generations=budget),
                       baseline_acc=baselines[name]["bb"].accuracy, doping_seeds=dope,
                       device=dev)
        st, _ = tr.run()
        require_state(f"{what} job {name}/{seed}", r.state, st, fields=FIELDS)
        if not (r.ok and r.generations_run == budget
                and (r.unique_evals, r.cache_hits) == (tr.unique_evals, tr.cache_hits)):
            raise AssertionError(f"{what} job {name}/{seed}: ok {r.ok}, generations_run "
                                 f"{r.generations_run}, unique_evals/cache_hits "
                                 f"{(r.unique_evals, r.cache_hits)} vs the trainer's "
                                 f"{(tr.unique_evals, tr.cache_hits)}")


def serve_paths(dev, smi: str, baselines: dict) -> dict:
    """Phase 4f: the continuous-batching ``SearchServer``, each stream a path
    with the launch counts set to 0 just before it and read just after:
    (i) the suite stream under generation auto and phases, every retired
    job equal to its standalone ``GATrainer.run`` on the card, K1 once per
    admission and K3 (or K2 and K1) once per generation with an active
    lane, K3's lanes summed over its launches equal to the jobs' budgets;
    (ii) the device-variation stream (K4, K3 ``n_dev``); (iii)
    ``validate_state`` on every busy lane at every boundary, a poisoned
    lane flagged alone and quarantined; (iv) the ``[serve]`` times.
    → the launches of each path, and the auto stream's results (by job
    name), wall seconds, problems and config, which phase 4g holds the
    supervised stream to."""
    import torch
    from repro_torch.core import engine, prng, sweep
    from repro_torch.kernels.backend import BackendPolicy
    from repro_torch.serve import SearchServer

    launches, out = {}, {}
    budget_sum = sum(b for _, _, b in SERVE_JOBS)
    for backend in ("auto", "phases"):
        cfg = engine.GAConfig(pop_size=SUITE_POP, generations=SUITE_GENS,
                              backends=BackendPolicy(generation=backend))
        problems = {ds.name: (ds, p, dope) for ds, p, dope in suite_problems(dev, cfg, baselines)}
        srv = SearchServer.for_problems([p for _, p, _ in problems.values()],
                                        n_lanes=SERVE_LANES, segment_len=SERVE_SEGMENT,
                                        policy=SERVE_POLICY)
        (results, by_id, walls, k3_lanes), got, wall = counted(
            lambda srv=srv, problems=problems, backend=backend: serve_stream(
                srv, problems, SERVE_JOBS, validate=backend == "auto"))
        launches[f"serve {backend}"] = got
        if backend == "auto":
            auto = dict(results={r.name: r for r in results.values()}, wall=wall,
                        problems=problems, cfg=cfg)
        busy = generations_with_work(results.values(), SERVE_SEGMENT)
        want = ({"pop_mlp_correct": len(SERVE_JOBS), "pop_generation_kernel": busy}
                if backend == "auto" else
                {"pop_mlp_correct": len(SERVE_JOBS) + busy, "pop_variation_kernel": busy})
        require_launches(f"serve {backend}", got, want)
        if backend == "auto" and (len(k3_lanes) != busy or sum(k3_lanes) != budget_sum):
            raise AssertionError(f"serve auto: K3 covered {sum(k3_lanes)} lanes in "
                                 f"{len(k3_lanes)} launches, expected the budgets' sum "
                                 f"{budget_sum} in {busy}")
        if sorted(results) != sorted(by_id):
            raise AssertionError(f"serve {backend}: retired {sorted(results)}")
        require_trainer_parity(f"serve {backend}", results, by_id, problems, cfg, dev,
                               baselines)
        out[backend] = results
        seg_ms = [round(w * 1e3, 2) for w in walls]
        print(f"[serve] suite stream, generation {backend}: {len(SERVE_JOBS)} jobs "
              f"{[f'{n}/{s}:{b}' for n, s, b in SERVE_JOBS]} on {SERVE_LANES} lanes, pop "
              f"{SUITE_POP}, segments of {SERVE_SEGMENT}, policy {SERVE_POLICY}: makespan "
              f"{srv.segments_done} segments ({busy} generations with an active lane), "
              f"{wall:.2f} s; per segment {seg_ms} ms; {budget_sum / sum(walls):.2f} "
              f"generations/s summed over the lanes; launches {got}"
              f"{f'; K3 lanes per launch {k3_lanes}' if backend == 'auto' else ''}; every "
              f"job equals its standalone GATrainer.run (every field, unique_evals, "
              f"cache_hits); {smi}")
        if backend == "auto":
            # run_suite's batched generation for the same 4 lanes (the first
            # four jobs, ungated, every lane active), host clock between CUDA
            # events, beside the server's full segments
            first = [problems[n][1] for n, _, _ in SERVE_JOBS[:SERVE_LANES]]
            lanes = engine.stack_problems([sweep.pad_lane(p, srv.spec, srv.max_samples)
                                           for p in first])
            keys = torch.stack([prng.PRNGKey(s, dev)
                                for _, s, _ in SERVE_JOBS[:SERVE_LANES]])
            states, _ = engine.init_state(lanes, keys)
            gen_ms = time_ms(lambda: engine.generation(lanes, states), reps=3, warmup=1)
            # the server's steady segments: every lane busy, no admission
            steady = [k for k in range(len(walls))
                      if sum(r.admitted_segment <= k < r.retired_segment
                             for r in results.values()) == SERVE_LANES
                      and all(r.admitted_segment != k for r in results.values())]
            serve_ms = sum(walls[k] for k in steady) * 1e3 / (len(steady) * SERVE_SEGMENT)
            print(f"[serve] run_suite's batched generation of {SERVE_LANES} lanes (the "
                  f"first {SERVE_LANES} jobs, pop {SUITE_POP}, generation auto): "
                  f"{gen_ms:.2f} ms, against the server's {serve_ms:.2f} ms per generation "
                  f"over its segments with every lane busy and no admission ({steady}); "
                  f"{smi}")
    for jid in out["auto"]:
        require_state(f"serve job {jid} auto vs phases", out["phases"][jid].state,
                      out["auto"][jid].state, fields=FIELDS)

    # (ii) the device-variation stream: K4 per admission, K3 n_dev per
    # generation with an active lane
    mcfg = engine.GAConfig(pop_size=SUITE_POP, generations=SUITE_GENS,
                           variation_mode="mean", n_device_samples=K_DEV)
    problems = {ds.name: (ds, p, dope) for ds, p, dope in suite_problems(dev, mcfg, baselines)
                if ds.name in ("breast_cancer", "redwine")}
    srv = SearchServer.for_problems([p for _, p, _ in problems.values()], n_lanes=2,
                                    segment_len=SERVE_SEGMENT, policy=SERVE_POLICY)
    (results, by_id, walls, k3_lanes), got, wall = counted(
        lambda: serve_stream(srv, problems, SERVE_MC_JOBS))
    launches["serve mc"] = got
    busy = generations_with_work(results.values(), SERVE_SEGMENT)
    require_launches("serve mc", got, {"pop_mlp_correct_mc": len(SERVE_MC_JOBS),
                                       "pop_generation_kernel_mc": busy})
    if sum(k3_lanes) != sum(b for _, _, b in SERVE_MC_JOBS):
        raise AssertionError(f"serve mc: K3 n_dev covered {sum(k3_lanes)} lanes")
    require_trainer_parity("serve mc", results, by_id, problems, mcfg, dev, baselines)
    print(f"[serve] device-variation stream (variation_mode=mean, K={K_DEV}): "
          f"{[f'{n}/{s}:{b}' for n, s, b in SERVE_MC_JOBS]} on 2 lanes: makespan "
          f"{srv.segments_done} segments, {wall:.2f} s; launches {got}; every job equals "
          f"its standalone GATrainer.run; {smi}")

    # (iii) a poisoned lane: NaN in one lane's objectives after a segment is
    # flagged on that lane alone, and quarantine_lane frees it
    cfg = engine.GAConfig(pop_size=SUITE_POP, generations=SUITE_GENS)
    problems = {ds.name: (ds, p, dope) for ds, p, dope in suite_problems(dev, cfg, baselines)}
    srv = SearchServer.for_problems([p for _, p, _ in problems.values()],
                                    n_lanes=SERVE_LANES, segment_len=SERVE_SEGMENT)
    jobs = SERVE_JOBS[:SERVE_LANES]
    for name, seed, _ in jobs:
        _, prob, dope = problems[name]
        srv.submit(prob, generations=2 * SERVE_SEGMENT, seed=seed, doping_seeds=dope)
    srv.step()
    srv.lane_state(2).obj[0, 0] = float("nan")
    flags = [engine.validate_state(srv.lane_problem(lane), srv.lane_state(lane)).tolist()
             for lane in range(SERVE_LANES)]
    want = [[lane != 2, True, True, True] for lane in range(SERVE_LANES)]
    if flags != want:
        raise AssertionError(f"serve: validate_state flags {flags}, expected {want}")
    bad = srv.quarantine_lane(2, "finite_objectives")
    if bad.ok or bad.front is not None or 2 in srv.active_jobs or bad.generations_run != \
            SERVE_SEGMENT:
        raise AssertionError("serve: the quarantined lane was not freed as failed")
    rest = {r.job_id: r for r in srv.drain()}
    by_id = {i: (n, s, 2 * SERVE_SEGMENT) for i, (n, s, _) in enumerate(jobs) if i != bad.job_id}
    require_trainer_parity("serve after quarantine", rest, by_id, problems, cfg, dev, baselines)
    print(f"[serve] validate_state held on every busy lane at every boundary of the auto "
          f"stream; NaN written into lane 2's objectives: flags {flags} (finite_objectives "
          f"of lane 2 alone); quarantine_lane freed it (ok False, generations_run "
          f"{bad.generations_run}); the other {len(rest)} jobs still equal their trainers")
    return dict(launches=launches, auto=auto)


# -- the supervised server ---------------------------------------------------------

# phase 4f's suite stream under a Supervisor that checkpoints every 2 of its
# segments, with one fault of each kind on a fixed schedule keyed by the
# supervisor's segment index: a transient fault before segment 1's dispatch
# and an IO error in segment 1's checkpoint save (both retried), lane 0
# poisoned with NaN objectives after segment 1 (quarantined before step 2
# commits), step 4 bit-rotted after its save, a kill after segment 4; the
# recovery skips step 4 back to step 2
SUPERVISED_EVERY = 2
SUPERVISED_TIMEOUT_S = 300.0    # the fault-free stream's watchdog: far above a segment
SUPERVISED_CHAOS = dict(segment_faults=(1,), io_errors=(1,), poison={1: 0},
                        poison_leaf="obj", corrupt_steps=(4,), corrupt_kind="bitflip",
                        kill_after_segment=4)


def reckon_supervised(jobs, n_lanes: int, segment_len: int, every: int, chaos: dict) -> dict:
    """What the fault schedule implies, reckoned on the host from the jobs
    and the schedule alone, without the server: pending jobs enter free
    lanes in lane order, longest budget first (ties in submission order);
    each generation with an active lane is one K3 launch covering the
    active lanes; a job retires at the boundary where its budget is spent,
    the poisoned lane's job at its boundary; a checkpoint after every
    ``every``-th supervisor segment records the lanes and the queue under
    the segments done; the kill restores the newest step that is not
    corrupted, whose queued jobs are resubmitted in their order, and the
    run replays from there under a supervisor without faults. →
    admissions (one K1 launch each), K3 launches and their lanes summed,
    the restored step, the victim's job index, and the supervisor's stats
    at the kill and after the recovery."""
    pending = list(range(len(jobs)))          # job indices in submission order
    lanes = [None] * n_lanes                  # [job index, generations left]
    saved, out = {}, dict(admissions=0, k3=0, k3_lanes=0, victim=None)
    stats = [dict(segments=0, retries=0, checkpoints=0, quarantined=0, converged=0)
             for _ in range(2)]
    idx = done = 0
    killed = False
    while pending or any(lanes):
        for lane in range(n_lanes):
            if lanes[lane] is None and pending:
                j = max(pending, key=lambda j: (jobs[j][2], -j))
                pending.remove(j)
                lanes[lane] = [j, jobs[j][2]]
                out["admissions"] += 1
        if any(lanes):
            for t in range(segment_len):
                active = sum(lane is not None and lane[1] > t for lane in lanes)
                out["k3"] += active > 0
                out["k3_lanes"] += active
            done += 1
            for lane in lanes:
                if lane is not None:
                    lane[1] -= segment_len
            lanes = [lane if lane is not None and lane[1] > 0 else None for lane in lanes]
        st = stats[killed]
        st["segments"] += 1
        st["retries"] += not killed and idx in chaos["segment_faults"]
        victim_lane = None if killed else chaos["poison"].get(idx)
        if victim_lane is not None:
            out["victim"], lanes[victim_lane] = lanes[victim_lane][0], None
            st["quarantined"] += 1
        if (idx + 1) % every == 0:
            saved[done] = ([None if lane is None else list(lane) for lane in lanes],
                           list(pending))
            st["checkpoints"] += 1
            st["retries"] += not killed and idx in chaos["io_errors"]
        if not killed and idx >= chaos["kill_after_segment"]:
            killed = True
            out["restored"] = done = max(s for s in saved if s not in chaos["corrupt_steps"])
            lanes = [None if lane is None else list(lane) for lane in saved[done][0]]
            pending = list(saved[done][1])
            idx = done
            continue
        idx += 1
    out["stats"] = stats
    return out


def same_result(what: str, got, want):
    """A healthy JobResult equals phase 4f's: every state field, the front's
    objectives, ``unique_evals``, ``cache_hits``, ``generations_run``."""
    require_state(what, got.state, want.state, fields=FIELDS)
    if not (got.ok and (got.unique_evals, got.cache_hits, got.generations_run)
            == (want.unique_evals, want.cache_hits, want.generations_run)
            and same(got.front["objectives"], want.front["objectives"])):
        raise AssertionError(f"{what}: ok {got.ok}, accounting "
                             f"{(got.unique_evals, got.cache_hits, got.generations_run)} vs "
                             f"{(want.unique_evals, want.cache_hits, want.generations_run)}"
                             f" or front differs")


def payload_leaves(srv) -> dict:
    """The host copy of every leaf a save of ``srv`` writes but the meta
    blob, by name (the PRNG keys as the file's uint32)."""
    import dataclasses

    from repro_torch.checkpoint import manager

    states = dataclasses.replace(srv._states,
                                 key=srv._states.key.cpu().numpy().astype(np.uint32))
    return {name: np.asarray(leaf.cpu().numpy() if hasattr(leaf, "cpu") else leaf)
            for name, leaf in manager.named_leaves((states, srv._problems))}


def supervised_paths(dev, smi: str, bare: dict) -> dict:
    """Phase 4g: phase 4f's auto suite stream (``bare``: its results by job
    name, wall seconds, problems and config) under ``Supervisor`` with a
    checkpoint every 2 segments. (i) A checkpoint of a card server
    mid-stream: its bytes reckoned from the shapes, then written, verified
    and restored on the card and on the CPU, every leaf equal to the card
    server's. (ii) The fault-free supervised stream, a counted path, each
    segment on the watchdog's thread under the caller's stream: every
    job equal to phase 4f's, its wall time against the bare stream's, the
    validation's and the checkpoints' share. (iii) The fault schedule
    (:data:`SUPERVISED_CHAOS`), a counted path with the recovery inside:
    the retries, the quarantined victim naming its check, recovery from
    step 2, ``dropped_pending`` resubmitted; every healthy job equal to
    phase 4f's; K1 once per admission and once for the recovered server's
    construction, K3 and its lanes as :func:`reckon_supervised` reckons them
    from the schedule. → the launches of each counted path."""
    import tempfile

    import torch
    from repro_torch.checkpoint import manager
    from repro_torch.serve import (ChaosKill, ChaosPlan, FaultPolicy, SearchServer,
                                   Supervisor)

    problems, cfg, want = bare["problems"], bare["cfg"], bare["results"]
    probs = [p for _, p, _ in problems.values()]
    lanes_kw = dict(n_lanes=SERVE_LANES, segment_len=SERVE_SEGMENT)
    jobs = [serve_job(name, seed, budget, problems) for name, seed, budget in SERVE_JOBS]
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        # (i) one checkpoint of a card server after its first segment (four
        # lanes busy, four jobs queued)
        srv = SearchServer.for_problems(probs, policy=SERVE_POLICY, **lanes_kw)
        for job in jobs:
            srv.submit(job)
        srv.step()
        host = payload_leaves(srv)
        reckoned = sum(a.nbytes for a in host.values())
        rows = srv._states.cache.rows
        d = str(Path(tmp) / "one")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.save(d, allow_pending=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        manifest = manager.verify_checkpoint(d, srv.segments_done)
        verify_s = time.perf_counter() - t0
        files = sum(m["file_size"] for m in manifest["leaves"].values())
        payload = sum(int(np.prod(m["shape"])) * np.dtype(m["dtype"]).itemsize
                      for name, m in manifest["leaves"].items() if name != "2")
        if payload != reckoned:
            raise AssertionError(f"supervisor: the checkpoint holds {payload} B of leaves, "
                                 f"reckoned {reckoned} B from the shapes")
        restore_s = {}
        for where in (dev, torch.device("cpu")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            back = SearchServer.restore(d, srv.spec, cfg, device=where)
            torch.cuda.synchronize()
            restore_s[where.type] = time.perf_counter() - t0
            got = payload_leaves(back)
            bad = [n for n in host if not (n in got and got[n].dtype == host[n].dtype
                                           and same(got[n], host[n]))]
            if bad or sorted(got) != sorted(host) or back.active_jobs != srv.active_jobs \
                    or [p["name"] for p in back.dropped_pending] != \
                    [srv._jobs[j].name for j in srv.pending_jobs] \
                    or back._states.pop.device.type != where.type:
                raise AssertionError(f"supervisor: the {where.type} restore of the card's "
                                     f"checkpoint differs (leaves {bad})")
        print(f"[supervisor] checkpoint of {SERVE_LANES} lanes after one segment "
              f"(pop {cfg.pop_size}, G {srv.spec.n_genes}, {len(host) + 1} leaves): reckoned "
              f"from the shapes {reckoned} B, of it the EvalCache rows "
              f"{tuple(rows.shape)} {rows.dtype} {rows.numel() * rows.element_size()} B; "
              f"files {files} B with the meta blob and the .npy headers; save "
              f"{save_s:.3f} s, verify_checkpoint {verify_s:.3f} s, restore to the card "
              f"{restore_s[dev.type]:.3f} s, to the CPU {restore_s['cpu']:.3f} s; the CPU "
              f"and card restores equal the card server leaf for leaf; {smi}")
        del srv, back

        # (ii) the fault-free supervised stream
        sup = Supervisor.for_problems(
            probs, FaultPolicy(checkpoint_every=SUPERVISED_EVERY,
                               segment_timeout_s=SUPERVISED_TIMEOUT_S),
            directory=str(Path(tmp) / "clean"), scheduler_policy=SERVE_POLICY, **lanes_kw)
        spent = {"_validate": 0.0, "_maybe_checkpoint": 0.0}
        # the watchdog runs each segment on its own thread: record the thread
        # and the stream each segment ran on
        seen, server_step = [], sup.server.step

        def step_seen():
            seen.append((threading.get_ident(), torch.cuda.current_stream(dev)))
            return server_step()

        sup.server.step = step_seen

        def timed(name):
            fn = getattr(sup, name)

            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
                return out
            setattr(sup, name, run)

        for name in spent:
            timed(name)
        for job in jobs:
            sup.submit(job)

        def clean_stream():
            with k3_lanes_recorded() as k3:
                return sup.drain(), k3

        (results, k3), got, wall = counted(clean_stream)
        launches["supervised"] = got
        busy = generations_with_work(results, SERVE_SEGMENT)
        require_launches("supervised", got, {"pop_mlp_correct": len(SERVE_JOBS),
                                             "pop_generation_kernel": busy})
        if sum(k3) != sum(b for _, _, b in SERVE_JOBS):
            raise AssertionError(f"supervised: K3 covered {sum(k3)} lanes")
        caller = torch.cuda.current_stream(dev)
        if len(seen) != sup.stats["segments"] or any(
                t == threading.get_ident() or st != caller for t, st in seen):
            raise AssertionError(f"supervised: {len(seen)} segments of "
                                 f"{sup.stats['segments']} ran on the watchdog's thread "
                                 f"under the caller's stream")
        if sorted(r.name for r in results) != sorted(want):
            raise AssertionError(f"supervised: retired {[r.name for r in results]}")
        for r in results:
            same_result(f"supervised job {r.name}", r, want[r.name])
        share = (spent["_validate"] + spent["_maybe_checkpoint"]) / wall
        print(f"[supervisor] fault-free supervised stream (checkpoint every "
              f"{SUPERVISED_EVERY} segments, validation every boundary, each segment on "
              f"the watchdog's thread under a {SUPERVISED_TIMEOUT_S:.0f} s limit and the "
              f"caller's stream): {wall:.2f} s "
              f"against phase 4f's bare stream {bare['wall']:.2f} s "
              f"({wall / bare['wall'] - 1:+.1%}); validation {spent['_validate'] * 1e3:.1f} ms "
              f"over {sup.stats['segments']} boundaries, checkpoints "
              f"{spent['_maybe_checkpoint'] * 1e3:.1f} ms over {sup.stats['checkpoints']} "
              f"saves: {share:.1%} of the stream; stats {sup.stats}; launches {got}; every "
              f"job equals phase 4f's; {smi}")
        del sup

        # (iii) the fault schedule, the recovery inside the counted path
        plan = reckon_supervised(SERVE_JOBS, SERVE_LANES, SERVE_SEGMENT, SUPERVISED_EVERY,
                                 SUPERVISED_CHAOS)
        chaos_dir = str(Path(tmp) / "chaos")
        sup = Supervisor.for_problems(
            probs, FaultPolicy(checkpoint_every=SUPERVISED_EVERY, backoff_base_s=0.0),
            directory=chaos_dir, chaos=ChaosPlan(**SUPERVISED_CHAOS),
            scheduler_policy=SERVE_POLICY, **lanes_kw)
        for job in jobs:
            sup.submit(job)
        seen = {}

        def chaos_stream():
            results = []
            with k3_lanes_recorded() as k3:
                try:
                    while sup.server.has_work:
                        results.extend(sup.step())
                    raise AssertionError("supervisor: the scheduled kill never came")
                except ChaosKill:
                    pass
                seen["killed"] = dict(sup.stats)
                seen["steps"] = manager.list_steps(chaos_dir)
                seen["valid"] = manager.latest_valid_step(chaos_dir)
                t0 = time.perf_counter()
                sup2 = Supervisor.recover(chaos_dir, sup.server.spec, cfg,
                                          FaultPolicy(checkpoint_every=SUPERVISED_EVERY),
                                          device=dev)
                seen["recover_s"] = time.perf_counter() - t0
                seen["pending"] = [m["name"] for m in sup2.dropped_pending]
                for m in sup2.dropped_pending:
                    name, seed = m["name"].split("/")
                    sup2.submit(serve_job(name, int(seed), m["generations"], problems))
                results.extend(sup2.drain())
            seen["sup2"] = sup2
            return results, k3

        (results, k3), got, wall = counted(chaos_stream)
    launches["supervised chaos"] = got
    sup2 = seen["sup2"]
    require_launches("supervised chaos", got, {
        "pop_mlp_correct": plan["admissions"] + 1, "pop_generation_kernel": plan["k3"]})
    if (len(k3), sum(k3)) != (plan["k3"], plan["k3_lanes"]):
        raise AssertionError(f"supervised chaos: K3 covered {sum(k3)} lanes in {len(k3)} "
                             f"launches, reckoned {plan['k3_lanes']} in {plan['k3']}")
    victim = SERVE_JOBS[plan["victim"]]
    victim = f"{victim[0]}/{victim[1]}"
    failed = [r for r in results if not r.ok]
    if [r.name for r in failed] != [victim] or "finite_objectives" not in failed[0].error \
            or failed[0].front is not None:
        raise AssertionError(f"supervised chaos: failed jobs "
                             f"{[(r.name, r.error) for r in failed]}, expected {victim} "
                             f"on finite_objectives")
    healthy = [r for r in results if r.ok]
    if sorted({r.name for r in healthy}) != sorted(set(want) - {victim}):
        raise AssertionError(f"supervised chaos: healthy jobs {[r.name for r in healthy]}")
    for r in healthy:
        same_result(f"supervised chaos job {r.name}", r, want[r.name])
    if ([seen["killed"], sup2.stats], sup2.recovered_step, seen["valid"]) != \
            (plan["stats"], plan["restored"], plan["restored"]):
        raise AssertionError(f"supervised chaos: stats {[seen['killed'], sup2.stats]} at the "
                             f"kill and after the recovery, reckoned {plan['stats']}; "
                             f"recovered step {sup2.recovered_step}, latest valid "
                             f"{seen['valid']}, reckoned {plan['restored']}")
    print(f"[supervisor] fault schedule {SUPERVISED_CHAOS}: at the kill stats "
          f"{seen['killed']}, steps {seen['steps']} (step 4 rotted), recovered step "
          f"{sup2.recovered_step} in {seen['recover_s']:.3f} s with dropped_pending "
          f"{seen['pending']} resubmitted; after it stats {sup2.stats}; victim {victim}: "
          f"{failed[0].error}; {len(healthy)} healthy results ({len(set(r.name for r in healthy))}"
          f" jobs, replays included) equal phase 4f's; {wall:.2f} s; launches {got}, "
          f"reckoned K1 {plan['admissions']} admissions + 1 server, K3 {plan['k3']} launches "
          f"covering {plan['k3_lanes']} lanes; {smi}")
    return launches


def probe_phase() -> dict:
    """Phase 4c: the fallback chain's probe on the card. With the memo and
    the launch counts reset, ``resolve_backends(..., fallback=True)`` must
    launch the probe kernel once and downgrade nothing (warnings are
    errors); a second call answers from the memo."""
    import warnings

    import torch
    from repro_torch.kernels import _cuda, backend
    from repro_torch.kernels.backend import BackendPolicy, resolve_backends

    pol = BackendPolicy(fitness="kernel", variation="kernel", generation="kernel",
                        ranking="sweep")
    backend._KERNEL_OK.clear()
    backend._WARNED.clear()
    _cuda.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = resolve_backends(pol, fallback=True)
        first = dict(_cuda.LAUNCHES)
        again = resolve_backends(pol, fallback=True)
    torch.cuda.synchronize()
    if got != pol or again != pol:
        raise AssertionError(f"probe: the policy was downgraded: {got}")
    if first["probe"] != 1 or sum(first.values()) != 1 or _cuda.LAUNCHES["probe"] != 1:
        raise AssertionError(f"probe: launches {first}, then {dict(_cuda.LAUNCHES)}; "
                             "expected one probe launch, none from the memo")
    print(f"[probe] resolve_backends({pol}, fallback=True): unchanged, no warning; the probe "
          f"kernel launched once, the second call answered from the memo")
    return {"probe": 1}


def lane_numbers(lk: dict, suite, n_sm: int, clock_hz: float, smi: str) -> dict:
    """Phase 6 for the lane axis: each GA kernel's lane-axis launch alone
    (CUDA graph) against the same work as L single-lane launches, at the
    suite's shapes; a batched generation of the suite and its ranking's
    share against L single-lane generations."""
    import torch
    from repro_torch.core import engine
    from repro_torch.kernels.pop_generation.kernel import pop_generation_call
    from repro_torch.kernels.pop_mlp.kernel import pop_mlp_correct_call
    from repro_torch.kernels.pop_ranking import rank_select_rerank
    from repro_torch.kernels.pop_variation.kernel import pop_variation_call

    stacked, d, var, data = lk["stacked"], lk["d"], lk["var"], lk["data"]
    L, P = stacked.n_lanes, SUITE_POP
    G, topo = stacked.spec.n_genes, stacked.spec.topo
    pop = lk["pop"][:, :P].contiguous()
    deltas, samp = lk["deltas"], lk["samp"]
    S, n_in = d.x.shape[1:]
    n_out = topo.sizes[-1]
    rows = torch.tensor(P, dtype=torch.int32, device=pop.device)
    one = lambda a, i: a[i] if isinstance(a, torch.Tensor) and a.dim() else a   # noqa: E731

    def at(i):
        return dict(spec=stacked.spec, n_valid_samples=d.n_valid_samples[i],
                    out_mask=d.out_mask[i])

    def per_lane(make):
        launches = [make(i) for i in range(L)]
        return lambda: [c() for c in launches]

    # the work is each lane's own: its samples, on the padded layout
    data_b = sum(4 * (s * n_in + s) for s in samp) + 4 * L * (n_out + 1)
    var_b = L * 4 * (2 * P * G + P + 5 * G + 6 + 1)
    dev_b = L * 4 * (K_DEV * G + G)
    moved = int((deltas != 0).sum()) // L
    fit = ops_add(*((1, fitness_ops(topo, P, s)) for s in samp))
    fit_mc = ops_add(*((1, fitness_mc_ops(topo, P, s, K_DEV, moved)) for s in samp))
    vary = ops_add((L, variation_ops(P, G)))
    cases = {
        "pop_mlp_correct": (
            pop_mlp_correct_call(pop, d.x, d.labels, n_valid_rows=rows, **data)[0],
            per_lane(lambda i: pop_mlp_correct_call(pop[i], d.x[i], d.labels[i],
                                                    n_valid_rows=rows, **at(i))[0]),
            fit, 4 * L * (P * G + P) + data_b),
        "pop_mlp_correct_mc": (
            pop_mlp_correct_call(pop, d.x, d.labels, n_valid_rows=rows, dev=deltas,
                                 gene_high=d.genes.high, **data)[0],
            per_lane(lambda i: pop_mlp_correct_call(
                pop[i], d.x[i], d.labels[i], n_valid_rows=rows, dev=deltas[i],
                gene_high=d.genes.high[i], **at(i))[0]),
            fit_mc, 4 * L * (P * G + P * K_DEV) + data_b + dev_b),
        "pop_variation_kernel": (
            pop_variation_call(*var)[0],
            per_lane(lambda i: pop_variation_call(*(one(a, i) for a in var))[0]),
            vary, var_b + 4 * L * P * G),
        "pop_generation_kernel": (
            pop_generation_call(*var, d.x, d.labels, **data)[0],
            per_lane(lambda i: pop_generation_call(*(one(a, i) for a in var), d.x[i],
                                                   d.labels[i], **at(i))[0]),
            ops_add((1, vary), (1, fit)), var_b + data_b + 4 * L * (P * G + P)),
        "pop_generation_kernel_mc": (
            pop_generation_call(*var, d.x, d.labels, dev=deltas, **data)[0],
            per_lane(lambda i: pop_generation_call(*(one(a, i) for a in var), d.x[i],
                                                   d.labels[i], dev=deltas[i], **at(i))[0]),
            ops_add((1, vary), (1, fit_mc)), var_b + data_b + dev_b + 4 * L * (P * G + P * K_DEV)),
    }
    lanes = {}
    for name, (lane, single, ops, nbytes) in cases.items():
        ms = device_ms(lane, reps=20)
        per_ms = device_ms(single, reps=5)
        bound_ms, bound_by, pipe = bound(ops, nbytes, n_sm, clock_hz)
        lanes[name] = {"L": L, "ms": ms, "per_lane_launches_ms": per_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
        before = (f" (before its redesign {EARLIER_MS[f'{name} lanes']:.4f} ms, quoted from "
                  f"PERF.md)" if f"{name} lanes" in EARLIER_MS else "")
        print(f"[numbers] lane axis {name}: {L} suite lanes (padded {topo.sizes}, G={G}, "
              f"P={P}, own samples{f', K={K_DEV}' if 'mc' in name else ''}): one launch "
              f"{ms:.4f} ms on the device{before} vs {L} single-lane launches {per_ms:.4f} ms "
              f"({per_ms / ms:.2f}x); bound {bound_ms:.4f} ms by {bound_by} ({pipe}), "
              f"{bound_ms / ms:.1%} of bound; {smi}")
    # a whole batched generation of the suite and its ranking's share, host
    # clock between CUDA events (the card waits for the host-bound glue)
    states = suite.states
    gen_ms = time_ms(lambda: engine.generation(stacked, states), reps=3, warmup=1)
    pools = [(torch.cat([states.obj[i], states.obj[i]]), torch.cat([states.viol[i],
                                                                    states.viol[i]]))
             for i in range(L)]
    rank_ms = time_ms(lambda: [rank_select_rerank(o, v, P) for o, v in pools], reps=3,
                      warmup=1)
    lanes_1 = stacked.lanes()
    singles = [engine.state_at(states, i) for i in range(L)]
    seq_ms = time_ms(lambda: [engine.generation(p, s) for p, s in zip(lanes_1, singles)],
                     reps=3, warmup=1)
    print(f"[numbers] suite generation ({L} lanes, pop {P}, generation auto): batched "
          f"{gen_ms:.2f} ms, of which the {L} lanes' rank_select_rerank {rank_ms:.2f} ms "
          f"({rank_ms / gen_ms:.0%}); {L} single-lane generations {seq_ms:.2f} ms; {smi}")
    return dict(lanes=lanes, gen_ms=gen_ms, rank_ms=rank_ms, seq_ms=seq_ms)


def probe_numbers(dev, launches: int, smi: str) -> dict:
    """Phase 6 for the probe: its launch alone against its plain version
    and ``torch.add``."""
    import torch
    from repro_torch.kernels.probe import PROBE_SHAPE, probe_call, probe_kernel, probe_plain

    x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.int32,
                     device=dev).reshape(PROBE_SHAPE)
    err = require_equal("probe", probe_kernel(x), probe_plain(x))
    ms = device_ms(probe_call(x)[0], reps=50)
    plain_ms = time_ms(lambda: probe_plain(x), reps=50)
    lib_ms = time_ms(lambda: torch.add(x, 1), reps=50)
    nbytes = 2 * 4 * x.numel()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[numbers] probe {PROBE_SHAPE} int32: kernel {ms:.5f} ms on the device; plain "
          f"{plain_ms:.4f} ms; torch.add {lib_ms:.4f} ms; bound {bound_ms:.6f} ms by bytes "
          f"({nbytes} B); {launches} launch on the probe phase; {smi}")
    return {"name": "probe", "route": "cuda", "source": "src/repro_torch/csrc/probe.cu",
            "replaces": "src/repro/kernels/__init__.py:87", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": lib_ms}


def main() -> int:
    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2

    import numpy as np
    from repro_torch.core import GATrainer, engine, prng
    from repro_torch.core.genome import (GenomeSpec, MLPTopology,
                                         random_population, _slot_keys)
    from repro_torch.core.interop import state_to_numpy
    from repro_torch.data import load_dataset
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.backend import BackendPolicy
    from repro_torch.kernels.pop_mlp.kernel import (
        pop_mlp_correct, pop_mlp_correct_call, pop_mlp_correct_mc,
        pop_mlp_correct_mc_plain, pop_mlp_correct_plain)
    from repro_torch.kernels.pop_variation.kernel import (pop_variation_call,
                                                          pop_variation_kernel,
                                                          pop_variation_plain)
    from repro_torch.kernels.pop_generation.kernel import (
        pop_generation_call, pop_generation_kernel, pop_generation_plain)
    from repro_torch.kernels.pop_ranking import rank_select_rerank

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    # full float32 products in the plain versions (TF32 would change them)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = sm_clock_mhz * 1e6
    print(f"[device] {kind}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] bound rates: {n_sm} SMs x {sm_clock_mhz:.0f} MHz max SM clock "
          f"(nvidia-smi) x per-SM results per clock {PIPE_RATES}, issue {ISSUE_RATE} "
          f"(= {n_sm * ISSUE_RATE * clock_hz / 1e12:.2f} Tops/s); HBM "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet)")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    info = _cuda.build()
    print(f"[build] {'built' if info['built'] else 'found'} "
          f"{Path(info['dir']).relative_to(ROOT) / _cuda.LIBRARY} from "
          f"{len(_cuda.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")
    for line in info["ptxas"].splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    for source, entries in KERNEL_ENTRIES.items():
        for line in entry_ptxas(info["ptxas"], source, entries):
            print(f"[build] {line}")
    from repro_torch.kernels.pow2_matmul.kernel import SM90_SMEM_BYTES
    print(f"[build] K7 bf16 pow2_matmul_sm90: {SM90_SMEM_BYTES} bytes of dynamic shared "
          f"memory per block")
    for name, kernel, n_dev in (("K4 pop_mlp_correct_mc", "K4", K_DEV),
                                ("K3 n_dev pop_generation_kernel_mc", "K3", K_DEV),
                                ("K3 nominal pop_generation_kernel", "K3N", 1),
                                ("K1 pop_mlp_correct", "K1", 1)):
        print(f"[build] {name}: dynamic shared memory per block from its launcher at "
              f"K={n_dev}: {launch_smem(kernel, (16, 5, 10), n_dev)} bytes at pendigits "
              f"(16, 5, 10), {launch_smem(kernel, (21, 5, 10), n_dev)} at the suite's "
              f"(21, 5, 10)")

    # -- 3. kernels vs plain versions -------------------------------------
    max_err = dict.fromkeys(_cuda.LAUNCHES, 0)
    rng = np.random.default_rng(0)
    shapes = {}
    for ds_name in ("pendigits", "breast_cancer"):
        ds = load_dataset(ds_name)
        topo = MLPTopology(ds.topology)
        spec = GenomeSpec(topo)
        prob = engine.Problem.from_data(topo, ds.x_train, ds.y_train, device=dev)
        x, y = prob.x_int, prob.labels
        P, S, G = 256, y.shape[0], spec.n_genes
        t = prob.genes
        pop = random_population(prng.PRNGKey(int(rng.integers(2**31)), dev), t, 2 * P)
        for rows in (2 * P, 77, 0):
            for samp in (None, S // 2 + 3):
                n_rows = torch.tensor(rows, dtype=torch.int32, device=dev)
                got = pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=n_rows,
                                      n_valid_samples=samp)
                want = pop_mlp_correct_plain(pop, x, y, spec=spec, n_valid_rows=n_rows,
                                             n_valid_samples=samp)
                max_err["pop_mlp_correct"] = max(max_err["pop_mlp_correct"], require_equal(
                    f"pop_mlp_correct {ds_name} rows={rows} samples={samp}", got, want))
        a_rows, b_rows = pop[:P].contiguous(), pop[P:].contiguous()
        do_rows = torch.as_tensor(rng.random(P) < 0.7, device=dev)
        key = prng.PRNGKey(int(rng.integers(2**31)), dev)
        keys = _slot_keys(key, (0, 1, 2))
        # the main path's device-variation deltas (engine.device_deltas, K = 8)
        deltas = engine.device_deltas(engine.Problem.from_data(
            topo, ds.x_train, ds.y_train, engine.GAConfig(variation_mode="mean",
                                                          n_device_samples=K_DEV),
            device=dev))
        zero = torch.zeros_like(deltas)
        om = torch.ones(topo.sizes[-1], dtype=torch.int32, device=dev)
        om[-1] = 0                                  # one masked output column
        for rows, samp, mask in ((2 * P, None, None), (77, S // 2 + 3, None),
                                 (0, None, None), (2 * P, None, om), (150, S - 5, om)):
            n_rows = torch.tensor(rows, dtype=torch.int32, device=dev)
            kw = dict(spec=spec, n_valid_rows=n_rows, n_valid_samples=samp, out_mask=mask)
            case = f"{ds_name} rows={rows} samples={samp} mask={mask is not None}"
            got = pop_mlp_correct_mc(pop, x, y, deltas, t.high, **kw)
            want = pop_mlp_correct_mc_plain(pop, x, y, dev=deltas, gene_high=t.high, **kw)
            max_err["pop_mlp_correct_mc"] = max(max_err["pop_mlp_correct_mc"], require_equal(
                f"pop_mlp_correct_mc {case}", got, want))
            if got.shape != (2 * P, K_DEV) or (got[rows:] != 0).any():
                raise AssertionError(f"pop_mlp_correct_mc {case}: shape or skipped rows")
            nominal = pop_mlp_correct(pop, x, y, **kw)
            require_equal(f"pop_mlp_correct_mc {case} all-zero deltas vs pop_mlp_correct",
                          pop_mlp_correct_mc(pop, x, y, zero, t.high, **kw),
                          nominal[:, None].expand(-1, K_DEV))
            require_equal(f"pop_mlp_correct_mc {case} column 0 vs pop_mlp_correct",
                          got[:, 0], nominal)
        for pm in (0.02, 0.5):
            pm_t = torch.tensor(pm, dtype=torch.float32, device=dev)
            args = (a_rows, b_rows, do_rows, t.low, t.high, t.is_mask, t.mask_bits,
                    t.ids, keys, pm_t)
            max_err["pop_variation_kernel"] = require_equal(
                f"pop_variation_kernel {ds_name} pm={pm}",
                pop_variation_kernel(*args), pop_variation_plain(*args))
            ch_k, cnt_k = pop_generation_kernel(*args, x, y, spec=spec)
            ch_p, cnt_p = pop_generation_plain(*args, x, y, spec=spec)
            max_err["pop_generation_kernel"] = max(
                require_equal(f"pop_generation_kernel children {ds_name} pm={pm}", ch_k, ch_p),
                require_equal(f"pop_generation_kernel counts {ds_name} pm={pm}", cnt_k, cnt_p))
            for samp, mask in ((None, None), (S // 2 + 3, om)):
                kw = dict(spec=spec, n_valid_samples=samp, out_mask=mask)
                case = f"{ds_name} pm={pm} samples={samp} mask={mask is not None}"
                ch_m, cnt_m = pop_generation_kernel(*args, x, y, dev=deltas, **kw)
                ch_q, cnt_q = pop_generation_plain(*args, x, y, dev=deltas, **kw)
                max_err["pop_generation_kernel_mc"] = max(
                    max_err["pop_generation_kernel_mc"],
                    require_equal(f"pop_generation_kernel_mc children {case}", ch_m, ch_q),
                    require_equal(f"pop_generation_kernel_mc counts {case}", cnt_m, cnt_q))
                ch_n, cnt_n = pop_generation_kernel(*args, x, y, **kw)
                ch_z, cnt_z = pop_generation_kernel(*args, x, y, dev=zero, **kw)
                require_equal(f"pop_generation_kernel_mc {case} children vs nominal", ch_m, ch_n)
                require_equal(f"pop_generation_kernel_mc {case} all-zero deltas vs nominal",
                              cnt_z, cnt_n[:, None].expand(-1, K_DEV))
        shapes[ds_name] = dict(spec=spec, x=x, y=y, pop=pop[:P].contiguous(), deltas=deltas,
                               high=t.high,
                               args=(a_rows, b_rows, do_rows, t.low, t.high, t.is_mask,
                                     t.mask_bits, t.ids, keys,
                                     torch.tensor(0.02, dtype=torch.float32, device=dev)))
        print(f"[kernels] {ds_name}: P={P} G={G} S={S} K={K_DEV}: pop_mlp_correct (6 bound "
              f"cases), pop_mlp_correct_mc (5 bound cases, all-zero deltas == "
              f"pop_mlp_correct), pop_variation_kernel, pop_generation_kernel, "
              f"pop_generation_kernel_mc (children == nominal, all-zero deltas == nominal) "
              f"equal their plain versions")
    lk = lane_kernel_checks(dev)
    for name, e in lk["err"].items():
        max_err[name] = max(max_err[name], e)
    torch.cuda.synchronize()

    # -- 4. end to end -------------------------------------------------------
    ds = load_dataset("pendigits")
    topo = MLPTopology(ds.topology)
    per_run, trainers, launches = {}, {}, {}
    for mode in PATH_KERNELS:
        finals = {}
        _cuda.reset_launches()
        for backend in ("auto", "ref", "phases"):
            before = dict(_cuda.LAUNCHES)
            cfg = engine.GAConfig(pop_size=256, generations=GENERATIONS, seed=0,
                                  variation_mode=mode,
                                  backends=BackendPolicy(generation=backend))
            t0 = time.perf_counter()
            tr = GATrainer(topo, ds.x_train, ds.y_train, cfg, device=dev)
            state, _ = tr.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            leaves = state_to_numpy(state)
            n_obj = 2 if mode == "off" else 3
            if not (np.isfinite(leaves["obj"]).all() and leaves["obj"].shape == (256, n_obj)):
                raise AssertionError(f"{mode}/{backend}: objectives not finite or misshapen")
            if leaves["counts"].shape != ((256,) if mode == "off" else (256, K_DEV)):
                raise AssertionError(f"{mode}/{backend}: counts misshapen")
            low, high = tr.spec.low, tr.spec.high
            if not ((leaves["pop"] >= low).all() and (leaves["pop"] < high).all()):
                raise AssertionError(f"{mode}/{backend}: genomes out of bounds")
            finals[backend] = leaves
            trainers[mode, backend] = (tr, state)
            per_run[mode, backend] = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
            print(f"[e2e] pendigits pop 256 gens {GENERATIONS} variation_mode={mode} "
                  f"generation={backend}: {wall:.2f} s wall ({GENERATIONS / wall:.2f} gen/s "
                  f"incl. init), unique_evals {tr.unique_evals}, cache_hits {tr.cache_hits}, "
                  f"launches {per_run[mode, backend]}")
        launches[mode] = dict(_cuda.LAUNCHES)
        # ref updates the EvalCache; auto and phases carry init's through
        for backend, fields in (("ref", FIELDS), ("phases", FIELDS + CACHE)):
            for f in fields:
                if not same(finals["auto"][f], finals[backend][f]):
                    raise AssertionError(f"e2e {mode}: GAState.{f} differs between auto "
                                         f"and {backend}")
        missing = [k for k in PATH_KERNELS[mode] if launches[mode][k] == 0]
        if missing:
            raise AssertionError(f"e2e {mode}: kernels never launched on the path: {missing}")
        print(f"[e2e] variation_mode={mode}: auto/ref/phases final states bit-identical "
              f"(EvalCache too between auto and phases); launches {launches[mode]}")

    bc = load_dataset("breast_cancer")
    for mode in ("off", "worst", "mean"):
        small = engine.GAConfig(pop_size=32, generations=3, seed=5, variation_mode=mode)
        runs = {}
        for d in (dev, "cpu"):
            tr = GATrainer(MLPTopology(bc.topology), bc.x_train, bc.y_train, small, device=d)
            runs[str(d)] = tr.run()[0]
        # auto: kernel path on the card, ref on the CPU
        require_state(f"small run {mode} card vs CPU", runs[str(dev)], runs["cpu"],
                      fields=FIELDS)
        print(f"[e2e] breast_cancer pop 32 gens 3 variation_mode={mode}: card (kernels) == "
              f"CPU (plain paths), bit for bit")

    # -- 4b. the batched entry points; 4c. the fallback chain's probe; 4d. the
    # paper's pipeline; 4e. the islands; 4f. the search server; 4g. the
    # supervised server ---------------------------------------------------------------
    baselines = {}      # each suite dataset's float net, bespoke baseline, doping
    batched = batched_paths(dev, baselines)
    probe_launches = probe_phase()
    pipeline = paper_pipeline(dev, smi, baselines)
    isl = island_paths(dev, smi)          # launches per counted path
    serve = serve_paths(dev, smi, baselines)
    supervised = supervised_paths(dev, smi, serve["auto"])

    # -- 5. LM-side ops --------------------------------------------------------
    lm = lm_path(dev)

    # -- 6. numbers ------------------------------------------------------------
    sh = shapes["pendigits"]
    spec, x, y, pop, args = sh["spec"], sh["x"], sh["y"], sh["pop"], sh["args"]
    P, G = pop.shape
    S, n_in = x.shape
    n_out = spec.topo.sizes[-1]
    f_ops = fitness_ops(spec.topo, P, S)
    v_ops = variation_ops(P, G)
    deltas, high = sh["deltas"], sh["high"]
    K = deltas.shape[0]
    mc_ops = fitness_mc_ops(spec.topo, P, S, K, int((deltas != 0).sum()))
    dev_bytes = 4 * (K * G + G)                            # delta table, gene bounds
    data_bytes = 4 * (S * n_in + S + n_out + 1)           # samples, labels, out_mask, bound
    var_bytes = 4 * (2 * P * G + P + 5 * G + 6 + 1)       # parents, gates, table, keys, pm
    # device-side bounds: a host int would be copied to the card in each call
    all_rows = torch.tensor(P, dtype=torch.int32, device=dev)
    all_samples = torch.tensor(S, dtype=torch.int32, device=dev)
    # Each kernel's launch prepared once (operands checked and converted,
    # outputs allocated) and timed alone; the wrapper, which redoes that
    # preparation in every call, is timed beside it. Repeated launches of a
    # fitness kernel add into the same counts: the same work, a wrong sum.
    specs = {
        "pop_mlp_correct_mc": dict(
            source="src/repro_torch/csrc/pop_mlp.cu",
            replaces="src/repro/kernels/pop_mlp/kernel.py:184",
            launch=pop_mlp_correct_call(pop, x, y, spec=spec, n_valid_rows=all_rows,
                                        n_valid_samples=all_samples, dev=deltas,
                                        gene_high=high)[0],
            wrapper=lambda: pop_mlp_correct_mc(pop, x, y, deltas, high, spec=spec,
                                               n_valid_rows=all_rows,
                                               n_valid_samples=all_samples),
            plain=lambda: pop_mlp_correct_mc_plain(pop, x, y, spec=spec, dev=deltas,
                                                   gene_high=high),
            ops=mc_ops, nbytes=4 * (P * G + 1 + P * K) + data_bytes + dev_bytes),
        "pop_generation_kernel_mc": dict(
            source="src/repro_torch/csrc/pop_generation.cu",
            replaces="src/repro/kernels/pop_generation/kernel.py:114 (n_dev branch, :89-107)",
            launch=pop_generation_call(*args, x, y, spec=spec, n_valid_samples=all_samples,
                                       dev=deltas)[0],
            wrapper=lambda: pop_generation_kernel(*args, x, y, spec=spec,
                                                  n_valid_samples=all_samples, dev=deltas),
            plain=lambda: pop_generation_plain(*args, x, y, spec=spec, dev=deltas),
            ops=ops_add((1, v_ops), (1, mc_ops)),
            nbytes=var_bytes + data_bytes + dev_bytes + 4 * (P * G + P * K)),
        "pop_mlp_correct": dict(
            source="src/repro_torch/csrc/pop_mlp.cu",
            replaces="src/repro/kernels/pop_mlp/kernel.py:94",
            launch=pop_mlp_correct_call(pop, x, y, spec=spec, n_valid_rows=all_rows,
                                        n_valid_samples=all_samples)[0],
            wrapper=lambda: pop_mlp_correct(pop, x, y, spec=spec, n_valid_rows=all_rows,
                                            n_valid_samples=all_samples),
            plain=lambda: pop_mlp_correct_plain(pop, x, y, spec=spec),
            ops=f_ops, nbytes=4 * (P * G + 1 + P) + data_bytes),
        "pop_variation_kernel": dict(
            source="src/repro_torch/csrc/pop_variation.cu",
            replaces="src/repro/kernels/pop_variation/kernel.py:77",
            launch=pop_variation_call(*args)[0],
            wrapper=lambda: pop_variation_kernel(*args),
            plain=lambda: pop_variation_plain(*args),
            ops=v_ops, nbytes=var_bytes + 4 * P * G),
        "pop_generation_kernel": dict(
            source="src/repro_torch/csrc/pop_generation.cu",
            replaces="src/repro/kernels/pop_generation/kernel.py:114",
            launch=pop_generation_call(*args, x, y, spec=spec,
                                       n_valid_samples=all_samples)[0],
            wrapper=lambda: pop_generation_kernel(*args, x, y, spec=spec,
                                                  n_valid_samples=all_samples),
            plain=lambda: pop_generation_plain(*args, x, y, spec=spec),
            ops=ops_add((1, v_ops), (1, f_ops)),
            nbytes=var_bytes + data_bytes + 4 * (P * G + P)),
    }
    saved = dict(_cuda.LAUNCHES)
    # launches per generation on the backend that runs each kernel: auto
    # launches a fitness kernel once (init), ref adds one a generation
    home = {"pop_mlp_correct": ("off", "ref"), "pop_variation_kernel": ("off", "phases"),
            "pop_generation_kernel": ("off", "auto"), "pop_mlp_correct_mc": ("mean", "ref"),
            "pop_generation_kernel_mc": ("mean", "auto")}
    rows = []
    for name in home:
        s = specs[name]
        mode, backend = home[name]
        ms = device_ms(s["launch"], reps=50)
        wrapper_ms = device_ms(s["wrapper"], reps=50)
        call_ms = time_ms(s["wrapper"], reps=50)
        plain_ms = time_ms(s["plain"], reps=3, warmup=1)
        bound_ms, bound_by, pipe = bound(s["ops"], s["nbytes"], n_sm, clock_hz)
        init = per_run[mode, "auto"][name] if backend == "ref" else 0
        per_gen = (per_run[mode, backend][name] - init) / GENERATIONS
        before = (f" (before its redesign {EARLIER_MS[name]:.4f} ms, quoted from PERF.md)"
                  if name in EARLIER_MS else "")
        print(f"[numbers] {name} pendigits P={P} G={G} S={S}"
              f"{f' K={K}' if mode != 'off' else ''}: kernel {ms:.4f} ms on the "
              f"device{before} (wrapper {wrapper_ms:.4f} ms on the device, {call_ms:.4f} ms a call "
              f"from the host; plain {plain_ms:.3f} ms); bound {bound_ms:.4f} ms by "
              f"{bound_by} (ops per pipe {s['ops']}, bounding term {pipe}; {s['nbytes']} B), "
              f"{bound_ms / ms:.1%} of bound; {per_gen:.2f} launches/generation on "
              f"variation_mode={mode} generation={backend}; {smi}")
        rows.append({"name": name, "route": "cuda", "source": s["source"],
                     "replaces": s["replaces"],
                     "launches": launches[mode][name] + sum(
                         n.get(name, 0) for n in (*batched["launches"].values(),
                                                  *pipeline["launches"].values(),
                                                  *isl.values(),
                                                  *serve["launches"].values(),
                                                  *supervised.values())),
                     "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    # one whole generation from the final state of each e2e run, and the
    # ranking tail alone. CUDA events around host-bound work measure the
    # host's time: the card waits between the events for what it is sent.
    for mode in PATH_KERNELS:
        fin = trainers[mode, "auto"][1]
        pool_obj, pool_viol = torch.cat([fin.obj, fin.obj]), torch.cat([fin.viol, fin.viol])
        rank_ms = time_ms(lambda: rank_select_rerank(pool_obj, pool_viol, P), reps=3,
                          warmup=1)
        for backend in ("auto", "ref", "phases"):
            tr, state = trainers[mode, backend]
            gen_ms = time_ms(lambda tr=tr, state=state: engine.generation(tr.problem, state),
                             reps=5, warmup=1)
            print(f"[numbers] variation_mode={mode} generation={backend} pendigits pop {P}: "
                  f"{gen_ms:.2f} ms per generation; rank_select_rerank alone (sweep, Python "
                  f"loop, pool {2 * P}, {pool_obj.shape[1]} objectives) {rank_ms:.2f} ms; {smi}")
    ln = lane_numbers(lk, batched["suite"], n_sm, clock_hz, smi)
    for row in rows:
        row["lane_axis"] = ln["lanes"][row["name"]]
    rows += lm_numbers(lm, n_sm, clock_hz, smi)
    rows.append(probe_numbers(dev, probe_launches["probe"], smi))
    # restore: the timing launches above are not main-path launches
    for k in saved:
        _cuda.LAUNCHES[k] = saved[k]

    print(f"[time] the whole script {time.perf_counter() - start:.1f} s; {smi}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
