"""Build the port's CUDA sources and load them through ``ctypes``.

Each ``nf_tpu_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/nf_tpu_torch/lib<name>-<hash>.so`` at the repository root, on first
use.  The hash covers the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source builds anew and an unchanged one is loaded
as it is.  ``build`` starts one ``nvcc`` per source that needs it, all at
once, and waits for all of them.  The compiler's output (``-Xptxas -v``:
registers, shared memory, spills) is kept beside each library as ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nf_tpu_torch"
SOURCES = ("fused_stack", "fused_stack_wide", "fused_stack_mma", "fused_flowpp",
           "fused_resflow", "fused_resflow_wide", "coupling", "attention", "attention_wide",
           "mixlogcdf")
# No fast math (--use_fast_math, -ftz=true): the Flow++ Newton guards with
# TINY = 1e-38, an f32 subnormal that flush-to-zero turns into 0, and with
# an isfinite test that fast math may drop.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default install location."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, in parallel."""
    names = tuple(names)
    pending = {}
    for name in names:
        so = library_path(name)
        if not so.exists():
            pending[name] = so
    if pending:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, so in pending.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            so = pending[name]
            so.with_suffix(".log").write_bytes(out)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out.decode(errors='replace')}")
                continue
            os.replace(tmp, so)   # atomic: concurrent builders never see half a file
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _loaded:
        if not torch.cuda.is_available():
            raise RuntimeError(f"cannot load the {name} CUDA kernels: no CUDA "
                               "device is available")
        _loaded[name] = ctypes.CDLL(str(build((name,))[name]))
    return _loaded[name]
