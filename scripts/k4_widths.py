"""Time K4 (``pop_mlp_correct_mc``) under other sets of compiled widths.

``src/repro_torch/csrc/pop_mlp.cu`` compiles K4's forwards for the (input,
hidden, output) widths listed in ``kMcBuckets`` (``csrc/common.cuh``): a
2-layer net runs the
smallest of them that holds it, its tables padded with zeros, and any other
net runs the general kernel. This script builds that source as it stands
(the package's library) and once for each set of widths in ``VARIANTS``
(``pop_mlp.cu`` compiled alone under ``build/k4_widths/`` beside a copy of
``common.cuh`` with the ``kMcBuckets`` line rewritten). At P = 256 and K = 8 device instances, on each
dataset's training samples at its paper topology and on pendigits' samples
at the padded suite's (21, 5, 10), it holds every build's counts against
the plain version, then times each build's launcher on the same prepared
arguments in turns (the builds in order, then in reverse order; CUDA graphs
of 50 launches, replayed 5 times between CUDA events; each build's mean of
its two timings). It prints ptxas's registers and spills for each compiled kernel
of each build, one line per topology with every build's time, and the
card's name and power limit. A mismatch or a failed build exits 1.

Run it on a CUDA host from the root of a checkout::

    PYTHONPATH=src python3 scripts/k4_widths.py
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

# the widths of the paper's five topologies and of the padded suite's, each
# compiled for itself
VARIANTS = {"exact": ((16, 5, 10), (21, 5, 10), (10, 3, 2), (21, 3, 3), (11, 2, 6),
                      (11, 4, 7))}
BUCKETS_LINE = re.compile(r"constexpr McDims kMcBuckets\[\] = \{.*\};")
P, K = 256, 8


def variant_header(csrc: Path, widths) -> str:
    """common.cuh with its compiled widths replaced by ``widths``."""
    line = ("constexpr McDims kMcBuckets[] = {"
            + ", ".join(f"{{{a}, {b}, {c}}}" for a, b, c in widths) + "};")
    src, n = BUCKETS_LINE.subn(line, (csrc / "common.cuh").read_text())
    if n != 1:
        raise RuntimeError("common.cuh has no single kMcBuckets line to rewrite")
    return src


def start_builds(_cuda) -> dict:
    """One nvcc process per variant, started together: {name: (library
    path, process)}."""
    procs = {}
    for name, widths in VARIANTS.items():
        out = _cuda.BUILD_ROOT.parent / "k4_widths" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _cuda.CSRC.glob("*.cuh"):
            shutil.copy(f, out / f.name)
        (out / "common.cuh").write_text(variant_header(_cuda.CSRC, widths))
        shutil.copy(_cuda.CSRC / "pop_mlp.cu", out / "pop_mlp.cu")
        lib = out / "libk4.so"
        cmd = [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-o", str(lib),
               str(out / "pop_mlp.cu")]
        procs[name] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
    return procs


def cases(dev):
    """(label, topology, spec, population, samples, labels, deltas, gene
    bounds) on the card."""
    import numpy as np

    from repro_torch.core import engine, prng
    from repro_torch.core.genome import MLPTopology, random_population
    from repro_torch.data import DATASETS, load_dataset

    cfg = engine.GAConfig(variation_mode="mean", n_device_samples=K)
    rng = np.random.default_rng(0)
    data = {name: load_dataset(name) for name in DATASETS}
    todo = [(name, d.topology, d.x_train, d.y_train) for name, d in data.items()]
    pend = data["pendigits"]
    todo.append(("suite (pendigits' samples)", (21, 5, 10),
                 np.pad(pend.x_train, ((0, 0), (0, 21 - pend.x_train.shape[1]))), pend.y_train))
    for label, sizes, x01, y01 in todo:
        prob = engine.Problem.from_data(MLPTopology(sizes), x01, y01, cfg, device=dev)
        pop = random_population(prng.PRNGKey(int(rng.integers(2**31)), dev), prob.genes, P)
        yield (label, tuple(sizes), prob.spec, pop, prob.x_int, prob.labels,
               engine.device_deltas(prob), prob.genes.high)


def main() -> int:
    import torch

    from chip_smoke import device_ms, entry_ptxas, nvidia_smi
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pop_mlp.kernel import (pop_mlp_correct_call,
                                                    pop_mlp_correct_mc_plain)
    from repro_torch.kernels.pop_mlp.ref import MC_BUCKETS

    if not torch.cuda.is_available():
        print("k4_widths: this script needs a CUDA card", file=sys.stderr)
        return 1
    procs = start_builds(_cuda)
    info = _cuda.build()
    libs = {"as built": _cuda.library()}
    logs = {"as built": info["ptxas"]}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"k4_widths: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(path))
        fn = libs[name].pop_mlp_correct_mc_launch
        fn.argtypes, fn.restype = _cuda._SIGNATURES["pop_mlp_correct_mc_launch"], ctypes.c_int
        logs[name] = f"== pop_mlp\n{log}"
    widths = {"as built": MC_BUCKETS, **VARIANTS}
    entries = {r"pop_mlp_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb1E":
               "K4 pop_mlp_tables_kernel<{0}, {1}, {2}, true>"}
    for name, log in logs.items():
        for line in entry_ptxas(log, "pop_mlp", entries):
            print(f"[k4_widths] [build] {name} {line}")

    smi = nvidia_smi("name,power.limit")
    dev = torch.device("cuda", 0)
    failed = False
    for label, sizes, spec, pop, x, y, deltas, high in cases(dev):
        launch, counts = pop_mlp_correct_call(pop, x, y, spec=spec, dev=deltas, gene_high=high)
        want = pop_mlp_correct_mc_plain(pop, x, y, spec=spec, dev=deltas, gene_high=high)
        runs = {}
        for name, lib in libs.items():
            fn = getattr(lib, launch.fn_name)

            def run(fn=fn, name=name):
                err = fn(*launch.args, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: {launch.fn_name} failed: cudaError {err}")

            counts.zero_()
            run()
            if not torch.equal(counts, want):
                print(f"k4_widths: {name} at {label} {sizes}: counts differ from the plain "
                      f"version", file=sys.stderr)
                failed = True
            runs[name] = run
        ms = dict.fromkeys(runs, 0.0)
        for name in [*runs, *reversed(runs)]:
            ms[name] += device_ms(runs[name], reps=50) / 2
        times = []
        for name in runs:
            held = [w for w in widths[name] if len(sizes) == 3
                    and all(a <= b for a, b in zip(sizes, w))]
            runs_as = (min(held, key=lambda w: w[0] * w[1] + w[1] * w[2]) if held
                       else "general")
            times.append(f"{name} {ms[name]:.4f} ms (kernel {runs_as})")
        print(f"[k4_widths] {label} {sizes} P={P} S={y.shape[0]} K={K}: " + "; ".join(times)
              + f"; {smi}")
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
