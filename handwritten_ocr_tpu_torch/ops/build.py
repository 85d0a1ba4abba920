"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the sources, so an edited kernel
never loads a stale build. Builds happen at first use, never at import,
and write through a temporary file renamed into place, so concurrent
processes cannot load a half-written library. :func:`build_all` starts one
``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("flash_attention", "window_attention", "paged_decode_attention")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``name``'s library lives; the digest covers the kernel source,
    the shared header and the compiler flags."""
    digest = hashlib.sha256()
    for source in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        digest.update(source.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names=KERNELS) -> dict[str, dict]:
    """Build every missing library in ``names`` in parallel.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the libraries
    built now (``ptxas`` holds the registers/shared-memory report); raises
    RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(_command(name, Path(tmp)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, Path(tmp), target, time.perf_counter())
    report = {}
    failures = []
    for name, (proc, tmp, target, t0) in running.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": output}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def launch(fn, *args) -> None:
    """Call a C entry point that returns ``cudaGetLastError()``; raise on
    a launch that CUDA refused."""
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {code}")
