"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

The ``csrc/*.cu`` sources build with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes. The first
:func:`library` call compiles every source at once (one ``nvcc -c`` process
per source, started together) and links the objects into
``build/repro_torch/<hash>/libreprotorch.so`` at the root of the checkout,
where ``<hash>`` covers the sources and the flags, so a changed source
rebuilds and an unchanged tree loads at once. Nothing here runs at import:
the CPU-only test host imports every module.

``LAUNCHES`` counts kernel launches by wrapper name; a :class:`Launch` adds
one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("pop_mlp", "pop_variation", "pop_generation")
LIBRARY = "libreprotorch.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

LAUNCHES = dict.fromkeys(("pop_mlp_correct", "pop_variation_kernel",
                          "pop_generation_kernel"), 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer (device buffers, host descriptor, stream) is a
# c_void_p, every size a c_int; each launcher returns the cudaError_t code.
_SIGNATURES = {
    "pop_mlp_correct_launch": (_P, _I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P),
    "pop_variation_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P),
    "pop_generation_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                              _I, _I, _P, _P, _P, _P, _P, _P),
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the repro_torch CUDA kernels build "
                       "with nvcc (set CUDA_HOME or put nvcc on PATH)")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmds: dict) -> dict:
    """Run the commands together; their output by name, or raise with the
    output of those that failed."""
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for n, c in cmds.items()}
    logs = {n: p.communicate()[0] for n, p in procs.items()}
    failed = [n for n, p in procs.items() if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def build() -> dict:
    """Build the library unless it is built; returns ``build_info`` (the
    output directory, the seconds spent, and nvcc's ptxas report per
    source). Raises with nvcc's output if a source does not compile."""
    out = _build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib, log = out / LIBRARY, out / "ptxas.log"
    t0 = time.perf_counter()
    built = not lib.exists()
    if built:
        tag = f"{os.getpid()}.tmp"
        objs = {n: out / f"{n}.{tag}.o" for n in SOURCES}
        logs = _run({n: [_nvcc(), *COMPILE_FLAGS, "-c", "-o", str(objs[n]),
                         str(CSRC / f"{n}.cu")] for n in SOURCES})
        tmp = out / f"{LIBRARY}.{tag}"
        _run({"link": [_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                       *map(str, objs.values())]})
        for o in objs.values():
            o.unlink()
        log.write_text("".join(f"== {n}\n{logs[n]}" for n in SOURCES))
        os.replace(tmp, lib)   # atomic: readers never see half a file
    build_info.update(dir=str(out), seconds=time.perf_counter() - t0, built=built,
                      ptxas=log.read_text() if log.exists() else "")
    return build_info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        if not build_info:
            build()
        lib = ctypes.CDLL(str(Path(build_info["dir"]) / LIBRARY))
        for fn_name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class Launch:
    """One prepared kernel call: the C launcher, its arguments, and the
    tensors and host buffers they point into (held here, so the pointers
    stay valid). Calling it launches the kernel on the current stream,
    raises if the launch was refused (``cudaGetLastError`` != 0) and adds
    one to ``LAUNCHES[name]``. A wrapper prepares and calls it once; a
    benchmark may call it again to time the launch alone."""

    def __init__(self, name: str, fn_name: str, args: tuple, keep: tuple):
        self.name, self.fn_name, self.args, self.keep = name, fn_name, args, keep

    def __call__(self) -> None:
        fn = getattr(library(), self.fn_name)
        err = fn(*self.args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.fn_name} failed: cudaError {err}")
        LAUNCHES[self.name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def host_ints(values) -> ctypes.Array:
    """A host int32 array for a descriptor argument (held by the
    :class:`Launch` that passes it)."""
    return (ctypes.c_int32 * len(values))(*values)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the launchers take raw pointers and trust all four)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def device_scalar(v, default: int, device: torch.device) -> torch.Tensor:
    """A () int32 bound on ``device``: ``default`` when ``v`` is None,
    else ``v`` (a Python int or a tensor already computed on the device —
    never read back to the host)."""
    if v is None:
        v = default
    return torch.as_tensor(v, dtype=torch.int32, device=device).reshape(())
