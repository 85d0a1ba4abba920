"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<digest>.so csrc/<name>.cu

The library name carries a digest of the kernel's source, every shared
header and the whole compiler command, so an edited kernel, header or
flag never loads a stale build. Builds happen at first use, never at import,
and write through a temporary file renamed into place, so concurrent
processes cannot load a half-written library (:func:`start_compile` /
:func:`finish_compile`, which ``native/`` also builds with). :func:`build_all`
starts one ``nvcc`` per source at once.
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
import weakref
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("flash_attention", "window_attention", "paged_decode_attention",
           "int8_matmul")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(name: str) -> list[str]:
    """The compiler command after ``nvcc``, without the output path."""
    return [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", f"-I{CSRC}", str(CSRC / f"{name}.cu")]


def library_path(name: str) -> Path:
    """Where ``name``'s library lives; the digest covers the kernel source,
    every ``csrc/*.cuh`` header and the compiler flags."""
    digest = hashlib.sha256()
    for source in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def start_compile(command: list[str], target: Path):
    """Start ``command -o <temp file beside target>``; returns the handle
    :func:`finish_compile` takes."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=target.suffix, dir=target.parent)
    os.close(fd)
    proc = subprocess.Popen([*command, "-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), target, time.perf_counter()


def finish_compile(handle, timeout: float | None = None) -> tuple[int, str]:
    """Wait for a :func:`start_compile`; on success rename its temp file
    onto the target, else remove it. Returns (exit code, compiler output);
    a compiler that outlives ``timeout`` is killed (exit code -9)."""
    proc, tmp, target, _ = handle
    try:
        output, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        output, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.returncode, output
    os.replace(tmp, target)
    return 0, output


def build_all(names=KERNELS) -> dict[str, dict]:
    """Build every missing library in ``names`` in parallel.

    Returns ``{name: {"seconds": s, "ptxas": text}}`` for the libraries
    built now (``ptxas`` holds the registers/shared-memory report); raises
    RuntimeError with the compiler's output when a build fails."""
    running = {name: start_compile([_nvcc(), *_flags(name)],
                                   library_path(name))
               for name in names if not library_path(name).exists()}
    report = {}
    failures = []
    for name, handle in running.items():
        code, output = finish_compile(handle)
        if code != 0:
            failures.append(f"{name}: nvcc exited {code}\n{output}")
            continue
        report[name] = {"seconds": time.perf_counter() - handle[3],
                        "ptxas": output}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """C entry point ``symbol`` of kernel ``name``'s library, its argument
    and return types set once (an int return: ``cudaGetLastError()``)."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def launch(fn, *args) -> None:
    """Call a C entry point that returns ``cudaGetLastError()``; raise on
    a launch that CUDA refused."""
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {code}")


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA ``device``."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


class Workspace:
    """Scratch of one kernel per device: fp32 partials and int32 arrival
    counters. A buffer grows (to the next power of two) when a call needs
    more than it holds and is reused by every later call; it is zeroed
    only when it is allocated, which the counters rely on: the kernels
    reset each counter to 0 before they finish.

    A CUDA graph captures the buffers its launches take: the capture holds
    :meth:`held` for as long as the graph lives, so a buffer replaced by a
    larger one stays the graph's. A buffer cannot grow during a capture
    (its zero fill would become a node of the graph): the call runs once
    before it is captured."""

    _instances: "weakref.WeakSet[Workspace]" = weakref.WeakSet()

    def __init__(self):
        self._buffers = {}
        self.allocations = 0
        Workspace._instances.add(self)

    @classmethod
    def held(cls) -> list:
        """Every buffer the workspaces hold now."""
        return [buf for workspace in cls._instances
                for buf in workspace._buffers.values()]

    def take(self, device, dtype, numel: int):
        """A ``dtype`` buffer of at least ``numel`` elements on ``device``
        (for counters, all of them 0)."""
        import torch
        key = (device, dtype)
        buf = self._buffers.get(key)
        if buf is None or buf.numel() < numel:
            if torch.device(device).type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel workspace cannot grow while a "
                                   "CUDA graph is captured: run the call "
                                   "once before capturing it")
            size = 1 << max(numel - 1, 1).bit_length()
            buf = torch.zeros(size, dtype=dtype, device=device)
            self._buffers[key] = buf
            self.allocations += 1
        return buf
