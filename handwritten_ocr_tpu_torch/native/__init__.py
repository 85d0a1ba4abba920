"""Native C++ text-metric engine (ctypes bindings; port of
``handwritten_ocr_tpu/native``).

``edit_distance_u32`` and ``lcs_align`` call ``fasttext.cpp``, the JAX
package's C ABI (``edit_distance_u32``, ``lcs_align_i64``) and results.
``text/metrics.py:edit_distance_ids`` and ``text/merge.py:align_to_backbone``
take it where it is available, else their NumPy engines; the two return
the same integers (``tests/test_torch_native.py``).

The library is built with g++ at first use, never at import, into the
git-ignored ``handwritten_ocr_tpu_torch/_build/`` under a name that
carries a digest of the source and the compiler flags, so an edited
source or flag never loads a stale build (no ``-march=native``: a build
directory may be carried to another host). It is written through a
temporary file renamed into place (``ops/build.py:start_compile``), so
concurrent processes cannot load a half-written library. Where g++ is missing or the
build fails, the NumPy engines run: this is host code, and both engines
are bit-equal by contract.

``HOCR_TPU_NO_NATIVE`` set to any non-empty value forces the NumPy
engines (read at each call). :func:`engine` names the engine in use.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
from pathlib import Path

import numpy as np

from handwritten_ocr_tpu_torch.ops.build import (BUILD_DIR, finish_compile,
                                                 start_compile)

__all__ = ["edit_distance_u32", "lcs_align", "available", "engine",
           "build_error"]

SOURCE = Path(__file__).resolve().parent / "fasttext.cpp"
FLAGS = ["-O3", "-shared", "-fPIC"]


def library_path() -> Path:
    """Where the library lives; the name carries a digest of the source
    and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfasttext-{digest.hexdigest()[:12]}.so"


@functools.cache
def _library() -> tuple[ctypes.CDLL | None, str | None]:
    """(the loaded library, None), or (None, why it is not there)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None, "g++ not found"
    target = library_path()
    if not target.exists():
        try:
            code, output = finish_compile(
                start_compile([gxx, *FLAGS, str(SOURCE)], target),
                timeout=120)
        except OSError as exc:
            return None, f"g++ failed: {exc}"
        if code != 0:
            return None, f"g++ exited {code}: {output}"
    try:
        lib = ctypes.CDLL(str(target))
    except OSError as exc:
        return None, f"{target} does not load: {exc}"
    lib.edit_distance_u32.restype = ctypes.c_int64
    lib.edit_distance_u32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
    ]
    lib.lcs_align_i64.restype = None
    lib.lcs_align_i64.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib, None


def _get_lib() -> ctypes.CDLL | None:
    if os.environ.get("HOCR_TPU_NO_NATIVE"):
        return None
    return _library()[0]


def available() -> bool:
    """True when the C++ engine runs (built, loaded, not switched off)."""
    return _get_lib() is not None


def engine() -> str:
    """The text engine in use: ``"cpp"`` or ``"numpy"``."""
    return "cpp" if available() else "numpy"


def build_error() -> str | None:
    """Why the library is not there (None when it is, or when
    ``HOCR_TPU_NO_NATIVE`` switched it off before any build)."""
    if os.environ.get("HOCR_TPU_NO_NATIVE"):
        return None
    return _library()[1]


def edit_distance_u32(a: np.ndarray, b: np.ndarray) -> int:
    """Unit-cost edit distance between two uint32 code vectors."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    ptr = ctypes.POINTER(ctypes.c_uint32)
    return int(lib.edit_distance_u32(a.ctypes.data_as(ptr), len(a),
                                     b.ctypes.data_as(ptr), len(b)))


def lcs_align(backbone: np.ndarray, words: np.ndarray) -> np.ndarray:
    """Aligned word index (or -1) per backbone position; see fasttext.cpp."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    backbone = np.ascontiguousarray(backbone, dtype=np.int64)
    words = np.ascontiguousarray(words, dtype=np.int64)
    out = np.empty(len(backbone), dtype=np.int64)
    ptr = ctypes.POINTER(ctypes.c_int64)
    lib.lcs_align_i64(backbone.ctypes.data_as(ptr), len(backbone),
                      words.ctypes.data_as(ptr), len(words),
                      out.ctypes.data_as(ptr))
    return out
