#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (a mismatch raises, nothing falls back):

1. device — the card's name, and ``nvidia-smi``'s name and power limit;
2. build — the three CUDA kernels from ``src/repro_torch/csrc`` into one
   shared library (nvcc, sm_90a, one compile per source, started
   together, then one link);
3. kernels vs plain — each kernel's wrapper against its plain PyTorch
   version on the same CUDA tensors at the main path's shapes (pendigits
   and breast_cancer, pop 256), exact equality (tolerance 0: integer
   outputs);
4. end to end — ``GATrainer.run`` at pendigits width (16, 5, 10), pop 256,
   with generation backends auto (megakernel), ref (EvalCache + fitness
   kernel) and phases (variation kernel + fitness kernel); the three final
   states must be bit-identical, every kernel must launch, and a small
   breast_cancer run on the card must equal the plain run on the CPU;
5. numbers — per kernel: the device time of its launch alone, operands
   prepared once (50 launches captured in a CUDA graph, replayed between
   CUDA events), the same for the whole wrapper, the time of a wrapper
   call from the host and of the plain version (CUDA events around the
   calls), the bound (the operations over the busiest SM pipe or the
   issue rate, or the bytes over 3.35 TB/s, whichever is larger),
   launches; and a whole generation.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
GENERATIONS = 20
FIELDS = ("pop", "obj", "viol", "rank", "crowd", "counts", "key", "gen")


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


def main() -> int:
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
    from repro_torch.kernels.pop_mlp.kernel import (pop_mlp_correct,
                                                    pop_mlp_correct_call,
                                                    pop_mlp_correct_plain)
    from repro_torch.kernels.pop_variation.kernel import (pop_variation_call,
                                                          pop_variation_kernel,
                                                          pop_variation_plain)
    from repro_torch.kernels.pop_generation.kernel import (
        pop_generation_call, pop_generation_kernel, pop_generation_plain)
    from repro_torch.kernels.pop_ranking import rank_select_rerank

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

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

    # -- 3. kernels vs plain versions -------------------------------------
    max_err = {"pop_mlp_correct": 0, "pop_variation_kernel": 0,
               "pop_generation_kernel": 0}
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
        shapes[ds_name] = dict(spec=spec, x=x, y=y, pop=pop[:P].contiguous(),
                               args=(a_rows, b_rows, do_rows, t.low, t.high, t.is_mask,
                                     t.mask_bits, t.ids, keys,
                                     torch.tensor(0.02, dtype=torch.float32, device=dev)))
        print(f"[kernels] {ds_name}: P={P} G={G} S={S}: pop_mlp_correct (6 bound cases), "
              f"pop_variation_kernel, pop_generation_kernel equal their plain versions")
    torch.cuda.synchronize()

    # -- 4. end to end -------------------------------------------------------
    ds = load_dataset("pendigits")
    topo = MLPTopology(ds.topology)
    finals, per_run, trainers = {}, {}, {}
    _cuda.reset_launches()
    for backend in ("auto", "ref", "phases"):
        before = dict(_cuda.LAUNCHES)
        cfg = engine.GAConfig(pop_size=256, generations=GENERATIONS, seed=0,
                              backends=BackendPolicy(generation=backend))
        t0 = time.perf_counter()
        tr = GATrainer(topo, ds.x_train, ds.y_train, cfg, device=dev)
        state, _ = tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leaves = state_to_numpy(state)
        if not (np.isfinite(leaves["obj"]).all() and leaves["obj"].shape == (256, 2)):
            raise AssertionError(f"{backend}: objectives not finite or misshapen")
        low, high = tr.spec.low, tr.spec.high
        if not ((leaves["pop"] >= low).all() and (leaves["pop"] < high).all()):
            raise AssertionError(f"{backend}: genomes out of bounds")
        finals[backend] = leaves
        trainers[backend] = (tr, state)
        per_run[backend] = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        print(f"[e2e] pendigits pop 256 gens {GENERATIONS} generation={backend}: "
              f"{wall:.2f} s wall ({GENERATIONS / wall:.2f} gen/s incl. init), "
              f"unique_evals {tr.unique_evals}, cache_hits {tr.cache_hits}, "
              f"launches {per_run[backend]}")
    launches = dict(_cuda.LAUNCHES)
    for backend in ("ref", "phases"):
        for f in FIELDS:
            a, b = finals["auto"][f], finals[backend][f]
            if not np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                                  b.view(np.int32) if b.dtype == np.float32 else b):
                raise AssertionError(f"e2e: GAState.{f} differs between auto and {backend}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"e2e: kernels never launched on the main path: {missing}")
    print(f"[e2e] auto/ref/phases final states bit-identical; launches {launches}")

    bc = load_dataset("breast_cancer")
    small = engine.GAConfig(pop_size=32, generations=3, seed=5)
    runs = {}
    for d in (dev, "cpu"):
        tr = GATrainer(MLPTopology(bc.topology), bc.x_train, bc.y_train, small, device=d)
        runs[str(d)] = state_to_numpy(tr.run()[0])
    for f in FIELDS:
        a, b = runs[str(dev)][f], runs["cpu"][f]
        if not np.array_equal(a.view(np.int32) if a.dtype == np.float32 else a,
                              b.view(np.int32) if b.dtype == np.float32 else b):
            raise AssertionError(f"small run: GAState.{f} differs between card and CPU")
    print("[e2e] breast_cancer pop 32 gens 3: card (kernels) == CPU (plain paths), bit for bit")

    # -- 5. numbers ------------------------------------------------------------
    sh = shapes["pendigits"]
    spec, x, y, pop, args = sh["spec"], sh["x"], sh["y"], sh["pop"], sh["args"]
    P, G = pop.shape
    S, n_in = x.shape
    n_out = spec.topo.sizes[-1]
    f_ops = fitness_ops(spec.topo, P, S)
    v_ops = variation_ops(P, G)
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
    before = dict(_cuda.LAUNCHES)
    rows = []
    for name, s in specs.items():
        ms = device_ms(s["launch"], reps=50)
        wrapper_ms = device_ms(s["wrapper"], reps=50)
        call_ms = time_ms(s["wrapper"], reps=50)
        plain_ms = time_ms(s["plain"], reps=3, warmup=1)
        bound_ms, bound_by, pipe = bound(s["ops"], s["nbytes"], n_sm, clock_hz)
        # auto launches the fitness kernel once (init); ref adds one a generation
        per_gen = {"pop_mlp_correct": (per_run["ref"][name] - per_run["auto"][name]),
                   "pop_variation_kernel": per_run["phases"][name],
                   "pop_generation_kernel": per_run["auto"][name]}[name] / GENERATIONS
        print(f"[numbers] {name} pendigits P={P} G={G} S={S}: kernel {ms:.4f} ms on the "
              f"device (wrapper {wrapper_ms:.4f} ms on the device, {call_ms:.4f} ms a call "
              f"from the host; plain {plain_ms:.3f} ms); bound {bound_ms:.4f} ms by "
              f"{bound_by} (ops per pipe {s['ops']}, bounding term {pipe}; {s['nbytes']} B), "
              f"{bound_ms / ms:.1%} of bound; {per_gen:.2f} launches/generation on its "
              f"backend; {smi}")
        rows.append({"name": name, "route": "cuda", "source": s["source"],
                     "replaces": s["replaces"], "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    # one whole generation from the final state of each e2e run, and the
    # ranking tail alone. CUDA events around host-bound work measure the
    # host's time: the card waits between the events for what it is sent.
    fin = trainers["auto"][1]
    pool_obj, pool_viol = torch.cat([fin.obj, fin.obj]), torch.cat([fin.viol, fin.viol])
    rank_ms = time_ms(lambda: rank_select_rerank(pool_obj, pool_viol, P), reps=3, warmup=1)
    for backend, (tr, state) in trainers.items():
        gen_ms = time_ms(lambda tr=tr, state=state: engine.generation(tr.problem, state),
                         reps=5, warmup=1)
        print(f"[numbers] generation={backend} pendigits pop {P}: {gen_ms:.2f} ms per "
              f"generation; rank_select_rerank alone (sweep, Python loop, pool {2 * P}) "
              f"{rank_ms:.2f} ms; {smi}")
    # restore: the timing launches above are not main-path launches
    for k in before:
        _cuda.LAUNCHES[k] = before[k]

    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
