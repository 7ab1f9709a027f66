"""Time K1 (``pop_mlp_correct``) and K3's ``n_dev`` branch under other tiles.

``src/repro_torch/csrc/common.cuh`` fixes each table kernel's tile: the
chromosomes a block takes, the samples each of its 128 threads counts, and
the blocks per SM its registers are capped for (``kK1Rows, kK1Samples,
kK1BlocksPerSM`` and the ``kK3`` line). This script builds the package's
library as it stands and, for each pair of tiles in ``VARIANTS``,
``pop_mlp.cu`` and ``pop_generation.cu`` into one library under
``build/mc_tiles/<name>/`` beside a copy of ``common.cuh`` with those two
lines rewritten (one nvcc process per variant, started together). On each of
the paper's five datasets at its topology (its training samples, P = 256
chromosomes, K = 8 device instances) it holds every build's K1 counts and
K3 ``n_dev`` children and counts against their plain versions, then times
each build's two launchers on the same prepared arguments in turns (the
builds in order, then in reverse order; CUDA graphs of 20 launches replayed
5 times between CUDA events; each build's mean of its two timings). It
prints ptxas's registers and spills of each build's K1 and K3 ``n_dev``
kernels, one line per dataset and kernel with every build's time, each
build's sum over the five datasets, and the card's name and power limit. A
mismatch or a failed build exits 1.

Run it on a CUDA host from the root of a checkout::

    PYTHONPATH=src python3 scripts/mc_tiles.py
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

# (chromosomes per block, samples per thread, blocks per SM) of K1 and of
# K3's n_dev branch, one pair a build
VARIANTS = {
    "v1": {"K1": (3, 1, 4), "K3": (2, 1, 4)},
    "v2": {"K1": (3, 2, 4), "K3": (2, 2, 4)},
    "v3": {"K1": (3, 4, 4), "K3": (2, 4, 4)},
    "v4": {"K1": (3, 8, 4), "K3": (2, 8, 4)},
    "v5": {"K1": (6, 4, 4), "K3": (2, 2, 3)},
    "v6": {"K1": (8, 4, 4), "K3": (2, 4, 3)},
    "v7": {"K1": (3, 16, 4), "K3": (4, 1, 4)},
    "v8": {"K1": (6, 8, 4), "K3": (4, 2, 4)},
}
P, K = 256, 8
ENTRIES = {r"pop_mlp_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0E":
           "K1 pop_mlp_tables_kernel<{0}, {1}, {2}, false>",
           r"pop_generation_mc_kernelILi(\d+)ELi(\d+)ELi(\d+)E":
           "K3 n_dev pop_generation_mc_kernel<{0}, {1}, {2}>"}


def tile_line(name: str, tile=None):
    """The regex of kernel ``name``'s tile line in common.cuh, or the line
    for ``tile``."""
    if tile is None:
        return re.compile(rf"constexpr int k{name}Rows = \d+, k{name}Samples = \d+, "
                          rf"k{name}BlocksPerSM = \d+;")
    rows, samples, bps = tile
    return (f"constexpr int k{name}Rows = {rows}, k{name}Samples = {samples}, "
            f"k{name}BlocksPerSM = {bps};")


def variant_header(csrc: Path, tiles: dict) -> str:
    """common.cuh with the tiles of ``tiles`` written in."""
    src = (csrc / "common.cuh").read_text()
    for name, tile in tiles.items():
        src, n = tile_line(name).subn(tile_line(name, tile), src)
        if n != 1:
            raise RuntimeError(f"common.cuh has no single k{name} tile line to rewrite")
    return src


def start_builds(_cuda) -> dict:
    """One nvcc process per variant, started together: {name: (library
    path, process)}."""
    procs = {}
    for name, tiles in VARIANTS.items():
        out = _cuda.BUILD_ROOT.parent / "mc_tiles" / name
        out.mkdir(parents=True, exist_ok=True)
        for f in _cuda.CSRC.glob("*.cuh"):
            shutil.copy(f, out / f.name)
        (out / "common.cuh").write_text(variant_header(_cuda.CSRC, tiles))
        for src in ("pop_mlp.cu", "pop_generation.cu"):
            shutil.copy(_cuda.CSRC / src, out / src)
        lib = out / "libmctiles.so"
        cmd = [_cuda._nvcc(), *_cuda.COMPILE_FLAGS, "-shared", "-o", str(lib),
               str(out / "pop_mlp.cu"), str(out / "pop_generation.cu")]
        procs[name] = lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)
    return procs


def cases(dev):
    """Per dataset: (name, topology, spec, K1's population, samples, labels,
    K3's variation operands, deltas) on the card."""
    import numpy as np
    import torch

    from repro_torch.core import engine, prng
    from repro_torch.core.genome import MLPTopology, _slot_keys, random_population
    from repro_torch.data import DATASETS, load_dataset

    cfg = engine.GAConfig(variation_mode="mean", n_device_samples=K)
    rng = np.random.default_rng(0)
    for name in DATASETS:
        d = load_dataset(name)
        prob = engine.Problem.from_data(MLPTopology(d.topology), d.x_train, d.y_train, cfg,
                                        device=dev)
        t = prob.genes
        pop = random_population(prng.PRNGKey(int(rng.integers(2**31)), dev), t, 2 * P)
        keys = _slot_keys(prng.PRNGKey(int(rng.integers(2**31)), dev), (0, 1, 2))
        var = (pop[:P].contiguous(), pop[P:].contiguous(),
               torch.as_tensor(rng.random(P) < 0.7, device=dev), t.low, t.high, t.is_mask,
               t.mask_bits, t.ids, keys, torch.tensor(0.02, dtype=torch.float32, device=dev))
        yield (name, tuple(d.topology), prob.spec, pop[:P].contiguous(), prob.x_int,
               prob.labels, var, engine.device_deltas(prob))


def main() -> int:
    import torch

    from chip_smoke import device_ms, entry_ptxas, nvidia_smi
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pop_generation.kernel import (pop_generation_call,
                                                           pop_generation_plain)
    from repro_torch.kernels.pop_mlp.kernel import pop_mlp_correct_call, pop_mlp_correct_plain
    from repro_torch.kernels.pop_mlp.ref import MC_TILES

    if not torch.cuda.is_available():
        print("mc_tiles: this script needs a CUDA card", file=sys.stderr)
        return 1
    procs = start_builds(_cuda)
    info = _cuda.build()
    libs = {"as built": _cuda.library()}
    logs = {"as built": info["ptxas"]}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"mc_tiles: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(path))
        for fn_name in ("pop_mlp_correct_launch", "pop_generation_mc_launch"):
            fn = getattr(libs[name], fn_name)
            fn.argtypes, fn.restype = _cuda._SIGNATURES[fn_name], ctypes.c_int
        logs[name] = f"== pop_mlp\n{log}\n== pop_generation\n{log}"
    tiles = {"as built": {k: MC_TILES[k] for k in ("K1", "K3")}, **VARIANTS}
    for name, log in logs.items():
        print(f"[mc_tiles] [build] {name}: K1 tile {tiles[name]['K1']}, K3 n_dev tile "
              f"{tiles[name]['K3']} (rows, samples a thread, blocks per SM)")
        seen = set()
        for source in ("pop_mlp", "pop_generation"):
            for line in entry_ptxas(log, source, ENTRIES):
                if line not in seen:
                    seen.add(line)
                    print(f"[mc_tiles] [build] {name} {line}")

    smi = nvidia_smi("name,power.limit")
    dev = torch.device("cuda", 0)
    failed = False
    total = {k: dict.fromkeys(libs, 0.0) for k in ("K1", "K3 n_dev")}
    for ds, sizes, spec, pop, x, y, var, deltas in cases(dev):
        rows = torch.tensor(P, dtype=torch.int32, device=dev)
        samp = torch.tensor(y.shape[0], dtype=torch.int32, device=dev)
        k1, k1_counts = pop_mlp_correct_call(pop, x, y, spec=spec, n_valid_rows=rows,
                                             n_valid_samples=samp)
        k3, k3_children, k3_counts = pop_generation_call(*var, x, y, spec=spec,
                                                         n_valid_samples=samp, dev=deltas)
        want = {"K1": (pop_mlp_correct_plain(pop, x, y, spec=spec),),
                "K3 n_dev": pop_generation_plain(*var, x, y, spec=spec, dev=deltas)}
        outs = {"K1": (k1_counts,), "K3 n_dev": (k3_children, k3_counts)}
        for kernel, launch in (("K1", k1), ("K3 n_dev", k3)):
            runs = {}
            for name, lib in libs.items():
                fn = getattr(lib, launch.fn_name)

                def run(fn=fn, name=name, launch=launch):
                    err = fn(*launch.args, torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"{name}: {launch.fn_name} failed: cudaError {err}")

                for o in outs[kernel]:
                    o.zero_()
                run()
                if not all(torch.equal(o, w) for o, w in zip(outs[kernel], want[kernel])):
                    print(f"mc_tiles: {name} {kernel} at {ds} {sizes}: differs from the plain "
                          f"version", file=sys.stderr)
                    failed = True
                runs[name] = run
            ms = dict.fromkeys(runs, 0.0)
            for name in [*runs, *reversed(runs)]:
                ms[name] += device_ms(runs[name], reps=20) / 2
            for name in runs:
                total[kernel][name] += ms[name]
            print(f"[mc_tiles] {kernel} {ds} {sizes} P={P} S={y.shape[0]}"
                  f"{f' K={K}' if kernel != 'K1' else ''}: "
                  + "; ".join(f"{name} {ms[name]:.4f} ms" for name in runs) + f"; {smi}")
    for kernel, t in total.items():
        best = min(t, key=t.get)
        print(f"[mc_tiles] {kernel} sum over the five datasets: "
              + "; ".join(f"{name} {v:.4f} ms" for name, v in t.items())
              + f"; fastest {best} {tiles[best][kernel.split()[0]]}; {smi}")
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
