"""Time K1 (``pop_mlp_correct``) and both branches of K3 under other tiles.

``src/repro_torch/csrc/common.cuh`` fixes each table kernel's tile: the
chromosomes a block takes, the samples each of its 128 threads counts, and
the blocks per SM its registers are capped for (``kK1Rows, kK1Samples,
kK1BlocksPerSM``, the ``kK3`` line of K3's ``n_dev`` branch and the ``kK3N``
line of its nominal branch). This script builds the package's library as it
stands and, for each set of tiles in ``VARIANTS``, ``pop_mlp.cu`` and
``pop_generation.cu`` into one library under ``build/mc_tiles/<name>/``
beside a copy of ``common.cuh`` with those lines rewritten (one nvcc
process per variant, started together). On each of the paper's five
datasets at its topology (its training samples, P = 256 chromosomes, K = 8
device instances) it holds every build's K1 counts and K3 children and
counts, both branches, against their plain versions, then times each
build's three launchers on the same prepared arguments in turns (the builds
in order, then in reverse order; CUDA graphs of 20 launches replayed 5
times between CUDA events; each build's mean of its two timings).

It then picks K3 nominal's tile by the rule of PERF.md section 6 (the least
sum over the five datasets; a four-row tile only if it beats the best
two-row one by 10 % or more).

It prints ptxas's registers and spills of each build's K1 and K3 kernels,
one line per dataset and kernel with every build's time, each build's sum
over the five datasets, the tile the rule picks, and the card's name and
power limit. A mismatch or a failed build exits 1.

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

# (chromosomes per block, samples per thread, blocks per SM) of K1, of K3's
# n_dev branch and of K3's nominal branch, one set a build
VARIANTS = {
    "v1": {"K1": (3, 1, 4), "K3": (2, 1, 4), "K3N": (2, 4, 4)},
    "v2": {"K1": (3, 2, 4), "K3": (2, 2, 4), "K3N": (2, 16, 4)},
    "v3": {"K1": (3, 4, 4), "K3": (2, 4, 4), "K3N": (4, 4, 4)},
    "v4": {"K1": (3, 8, 4), "K3": (2, 8, 4), "K3N": (4, 8, 4)},
    "v5": {"K1": (6, 4, 4), "K3": (2, 2, 3), "K3N": (4, 16, 4)},
    "v6": {"K1": (8, 4, 4), "K3": (2, 4, 3), "K3N": (2, 8, 3)},
    "v7": {"K1": (3, 16, 4), "K3": (4, 1, 4), "K3N": (2, 16, 3)},
    "v8": {"K1": (6, 8, 4), "K3": (4, 2, 4), "K3N": (4, 8, 3)},
}
P, K = 256, 8
KERNELS = {"K1": "K1", "K3 n_dev": "K3", "K3 nominal": "K3N"}   # kernel -> its tile line
LAUNCHERS = ("pop_mlp_correct_launch", "pop_generation_mc_launch", "pop_generation_launch")
ENTRIES = {r"pop_mlp_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0E":
           "K1 pop_mlp_tables_kernel<{0}, {1}, {2}, false>",
           r"pop_generation_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb1E":
           "K3 n_dev pop_generation_tables_kernel<{0}, {1}, {2}, true>",
           r"pop_generation_tables_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb0E":
           "K3 nominal pop_generation_tables_kernel<{0}, {1}, {2}, false>"}


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


def start_build(_cuda, name: str, tiles: dict):
    """One nvcc process building ``tiles`` under build/mc_tiles/<name>/:
    (library path, process)."""
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
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True)


def load_build(_cuda, name: str, path: Path, proc):
    """The built library with its launchers' signatures, and nvcc's output
    as two source sections; None if nvcc failed."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        print(f"mc_tiles: nvcc failed for {name}:\n{log}", file=sys.stderr)
        return None
    lib = ctypes.CDLL(str(path))
    for fn_name in LAUNCHERS:
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = _cuda._SIGNATURES[fn_name], ctypes.c_int
    return lib, f"== pop_mlp\n{log}\n== pop_generation\n{log}"


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


def time_builds(libs: dict, launch, outs: tuple, want: tuple, what: str):
    """Each build's launcher of ``launch`` on its prepared arguments: its
    outputs against ``want`` (False on a mismatch), then its device time in
    turns, builds in order then in reverse → (ok, {build: ms})."""
    import torch

    from chip_smoke import device_ms

    ok, runs = True, {}
    for name, lib in libs.items():
        fn = getattr(lib, launch.fn_name)

        def run(fn=fn, name=name):
            err = fn(*launch.args, torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{name}: {launch.fn_name} failed: cudaError {err}")

        for o in outs:
            o.zero_()
        run()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            print(f"mc_tiles: {name} {what}: differs from the plain version", file=sys.stderr)
            ok = False
        runs[name] = run
    ms = dict.fromkeys(runs, 0.0)
    for name in [*runs, *reversed(runs)]:
        ms[name] += device_ms(runs[name], reps=20) / 2
    return ok, ms


def pick_nominal(total: dict, tiles: dict) -> str:
    """The build whose K3 nominal tile the rule keeps: the least sum, a
    four-row tile only if it beats the best two-row one by 10 % or more."""
    best = min(total, key=total.get)
    two = min((n for n in total if tiles[n]["K3N"][0] == 2), key=total.get)
    return best if total[best] <= 0.9 * total[two] else two


def main() -> int:
    import torch

    from chip_smoke import entry_ptxas, nvidia_smi
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.pop_generation.kernel import (pop_generation_call,
                                                           pop_generation_plain)
    from repro_torch.kernels.pop_mlp.kernel import pop_mlp_correct_call, pop_mlp_correct_plain
    from repro_torch.kernels.pop_mlp.ref import MC_TILES

    if not torch.cuda.is_available():
        print("mc_tiles: this script needs a CUDA card", file=sys.stderr)
        return 1
    procs = {name: start_build(_cuda, name, tiles) for name, tiles in VARIANTS.items()}
    info = _cuda.build()
    libs = {"as built": _cuda.library()}
    logs = {"as built": info["ptxas"]}
    for name, (path, proc) in procs.items():
        built = load_build(_cuda, name, path, proc)
        if built is None:
            return 1
        libs[name], logs[name] = built
    tiles = {"as built": {k: MC_TILES[k] for k in ("K1", "K3", "K3N")}, **VARIANTS}

    def ptxas(name: str, log: str, label: str):
        print(f"[mc_tiles] [build] {name}: {label}")
        seen = set()
        for source in ("pop_mlp", "pop_generation"):
            for line in entry_ptxas(log, source, ENTRIES):
                if line not in seen:
                    seen.add(line)
                    print(f"[mc_tiles] [build] {name} {line}")

    for name, log in logs.items():
        ptxas(name, log, f"K1 tile {tiles[name]['K1']}, K3 n_dev tile {tiles[name]['K3']}, "
                         f"K3 nominal tile {tiles[name]['K3N']} (rows, samples a thread, "
                         f"blocks per SM)")

    smi = nvidia_smi("name,power.limit")
    dev = torch.device("cuda", 0)
    failed = False
    total = {k: dict.fromkeys(libs, 0.0) for k in KERNELS}
    for ds, sizes, spec, pop, x, y, var, deltas in cases(dev):
        rows = torch.tensor(P, dtype=torch.int32, device=dev)
        samp = torch.tensor(y.shape[0], dtype=torch.int32, device=dev)
        k1, k1_counts = pop_mlp_correct_call(pop, x, y, spec=spec, n_valid_rows=rows,
                                             n_valid_samples=samp)
        k3, k3_children, k3_counts = pop_generation_call(*var, x, y, spec=spec,
                                                         n_valid_samples=samp, dev=deltas)
        k3n, k3n_children, k3n_counts = pop_generation_call(*var, x, y, spec=spec,
                                                            n_valid_samples=samp)
        label = f"{ds} {sizes} P={P} S={y.shape[0]}"
        runs = {"K1": (k1, (k1_counts,), (pop_mlp_correct_plain(pop, x, y, spec=spec),)),
                "K3 n_dev": (k3, (k3_children, k3_counts),
                             pop_generation_plain(*var, x, y, spec=spec, dev=deltas)),
                "K3 nominal": (k3n, (k3n_children, k3n_counts),
                               pop_generation_plain(*var, x, y, spec=spec))}
        for kernel, (launch, outs, want) in runs.items():
            ok, ms = time_builds(libs, launch, outs, want, f"{kernel} at {label}")
            failed |= not ok
            for name in ms:
                total[kernel][name] += ms[name]
            print(f"[mc_tiles] {kernel} {label}{f' K={K}' if kernel == 'K3 n_dev' else ''}: "
                  + "; ".join(f"{name} {ms[name]:.4f} ms" for name in ms) + f"; {smi}")
    for kernel, t in total.items():
        best = min(t, key=t.get)
        print(f"[mc_tiles] {kernel} sum over the five datasets: "
              + "; ".join(f"{name} {v:.4f} ms" for name, v in t.items())
              + f"; fastest {best} {tiles[best][KERNELS[kernel]]}; {smi}")
    chosen = pick_nominal(total["K3 nominal"], tiles)
    print(f"[mc_tiles] K3 nominal by the rule: {chosen} {tiles[chosen]['K3N']}")
    print(smi)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
