"""ctypes bindings of the native host-side data tier (counterpart of
``nf_tpu/data/native.py``): the toy samplers, the epoch shuffle and the row
gather of ``nf_tpu_torch/csrc/sampler.cpp`` behind its ``extern "C"`` ABI
(version 1).

The library is compiled with ``g++ -O3`` on first use, never at import,
into ``build/nf_tpu_torch/libsampler-<hash>.so`` at the repository root;
the hash covers the source and the flags, so an edited source builds anew,
and a library that does not load (built on another machine) is built
anew too.
The compiler writes a temporary file that ``os.replace`` moves into place,
so processes that build at once never load half a library.  Without
``g++`` the tier is unavailable and the loader draws from numpy
(``data/toy.py``), as nf_tpu's does; a build that fails where ``g++``
exists is logged with the compiler's message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from ..utils.logging import Logging

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "sampler.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nf_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1

logger = Logging(__file__)
_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsampler-{digest[:16]}.so"


def _build(so: Path) -> bool:
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        out = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", tmp],
                             capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        os.unlink(tmp)
        logger.warn(f"native data tier: g++ failed to run: {e}")
        return False
    if out.returncode != 0:
        os.unlink(tmp)
        logger.warn(f"native data tier: g++ failed (exit {out.returncode}):\n"
                    f"{out.stderr or out.stdout}")
        return False
    os.replace(tmp, so)
    return True


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for name in ("sample_circles", "sample_moons", "sample_normals",
                 "sample_swiss", "sample_s_curve"):
        fn = getattr(lib, name)
        fn.argtypes = [f32p, ctypes.c_int64, ctypes.c_uint64]
        fn.restype = None
    lib.shuffled_indices.argtypes = [i64p, ctypes.c_int64, ctypes.c_uint64]
    lib.shuffled_indices.restype = None
    lib.gather_rows.argtypes = [f32p, f32p, i64p, ctypes.c_int64, ctypes.c_int64]
    lib.gather_rows.restype = None
    lib.nf_tpu_native_abi_version.argtypes = []
    lib.nf_tpu_native_abi_version.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; returns the configured
    ``ctypes.CDLL`` or raises ``OSError``."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            raise OSError("native data tier unavailable")
        so = library_path()
        lib = None
        if so.exists():
            try:
                lib = ctypes.CDLL(str(so))
            except OSError as e:   # e.g. built on another machine
                logger.warn(f"native data tier: {so.name} does not load ({e}); building it anew")
        if lib is None:
            if not _build(so):
                _load_failed = True
                raise OSError("native data tier build failed")
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                _load_failed = True
                raise
        lib = _configure(lib)
        if lib.nf_tpu_native_abi_version() != ABI_VERSION:
            _load_failed = True
            raise OSError("native data tier ABI mismatch")
        _lib = lib
        return _lib


def available() -> bool:
    """True if the library loads (building it if needed)."""
    try:
        load()
        return True
    except OSError:
        return False


def _sampler(c_name: str, event: int):
    def fn(n: int, seed: int) -> np.ndarray:
        lib = load()
        out = np.empty((n, event), dtype=np.float32)
        getattr(lib, c_name)(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             ctypes.c_int64(n), ctypes.c_uint64(seed & (2**64 - 1)))
        return out
    fn.__name__ = "native_" + c_name.removeprefix("sample_")
    return fn


native_circles = _sampler("sample_circles", 2)
native_moons = _sampler("sample_moons", 2)
native_normals = _sampler("sample_normals", 2)
native_swiss = _sampler("sample_swiss", 3)
native_s_curve = _sampler("sample_s_curve", 3)

NATIVE_SAMPLERS = {
    "circles": native_circles,
    "moons": native_moons,
    "normals": native_normals,
    "swiss": native_swiss,
    "s_curve": native_s_curve,
}


def shuffled_indices(n: int, seed: int) -> np.ndarray:
    """Fisher-Yates permutation of [0, n) from the native tier."""
    lib = load()
    out = np.empty((n,), dtype=np.int64)
    lib.shuffled_indices(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         ctypes.c_int64(n), ctypes.c_uint64(seed & (2**64 - 1)))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]] through the native row copy (float32)."""
    lib = load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    flat = src.reshape(src.shape[0], -1)
    dst = np.empty((idx.shape[0], flat.shape[1]), dtype=np.float32)
    lib.gather_rows(dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    ctypes.c_int64(idx.shape[0]), ctypes.c_int64(flat.shape[1]))
    return dst.reshape((idx.shape[0],) + src.shape[1:])
