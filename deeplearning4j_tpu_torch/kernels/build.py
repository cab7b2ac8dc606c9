"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point. At first use, nvcc
compiles it for `sm_90a` into `build/torch_kernels/lib<name>-<hash>.so`
under the repository root (a directory `.gitignore` lists). The hash
covers the source, the shared headers (`csrc/*.cuh`), the nvcc flags and
the compiler (its path and `--version`), so an edited source or header, a
changed flag or another nvcc rebuilds and nothing stale loads.
`build()` starts one nvcc per stale source, all at once. Nothing is compiled when a module is imported: the
CPU tests import every module, and the host has no nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SOURCES = ("flash_fwd", "flash_decode", "flash_bwd", "flash_decode_paged",
           "flash_fwd_bf16", "flash_bwd_bf16")
CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}          # name -> ctypes.CDLL
_functions = {}     # (name, symbol) -> bound ctypes function


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc():
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default home."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    return None


@functools.cache
def _toolchain_id():
    """nvcc's path and `--version` text ("" when there is no nvcc)."""
    nvcc = find_nvcc()
    if nvcc is None:
        return ""
    return nvcc + "\n" + subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True,
        timeout=60).stdout


def library_path(name):
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(_toolchain_id().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose=False):
    """Compile every named source whose library is missing, one nvcc
    process each, all started together. Returns {name: compiler stderr}
    for the sources it built (with `verbose`, ptxas's register and shared
    memory report). Raises KernelBuildError on any failure."""
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            f"kernels {todo} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{n}.cu")]
        jobs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True),
                   tmp, out)
    logs, failures = {}, []
    for n, (proc, tmp, out) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{n}.cu (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a .so
        logs[n] = err
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return logs


def build_timed(verbose=False):
    """(seconds, logs) for building every kernel of the package."""
    t0 = time.perf_counter()
    logs = build(SOURCES, verbose=verbose)
    return time.perf_counter() - t0, logs


def kernel_function(name, symbol, argtypes):
    """The C entry `symbol` of kernel library `name`, built at first use,
    with its argument types set (int return = cudaError_t)."""
    key = (name, symbol)
    with _lock:
        fn = _functions.get(key)
        if fn is None:
            lib = _libs.get(name)
            if lib is None:
                build((name,))
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _functions[key] = fn
        return fn
