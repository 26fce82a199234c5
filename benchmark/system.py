"""The system under test: the port's served program, built from a
configuration file and the state the benchmark drew.

This is the only module of the benchmark that imports `nf_tpu_torch`.  It
takes from it the model builder, the serving program (`EvalProgram`), the
kernel wrappers' launch counters and the kernels' names.
"""
from __future__ import annotations

import importlib
import pkgutil
import re
from pathlib import Path

import torch

import nf_tpu_torch
from nf_tpu_torch.config import NetworkConfig
from nf_tpu_torch.models import build_model

CSRC = Path(nf_tpu_torch.__file__).resolve().parent / "csrc"


def served_program(cfg: dict, state: dict, device):
    """(model, EvalProgram) of the configuration, its state loaded."""
    net = NetworkConfig(name=cfg["network"], **cfg["network_config"])
    model = build_model(cfg["network"], tuple(cfg["dims"]), cfg["datatype"], cfg=net,
                        device=device)
    model.load_state_dict(state, strict=True)
    return model, model.eval_program()


def serve(program, kind: str, x=None, rows=None, generator=None):
    """One request: `log_prob` answers log p(x) (B,); `sample` answers
    (y, log p(y)) for `rows` draws from `generator`."""
    if kind == "log_prob":
        return program.log_prob(x)
    if kind == "sample":
        return program.sample(rows, generator)
    raise ValueError(f"unknown request kind {kind!r}")


def launch_counts() -> dict:
    """{kernel counter: launches so far} over the port's kernel wrappers."""
    import nf_tpu_torch.ops.cuda as cuda_ops
    counts = {}
    for info in pkgutil.iter_modules(cuda_ops.__path__):
        mod = importlib.import_module(f"{cuda_ops.__name__}.{info.name}")
        counts.update(getattr(mod, "LAUNCHES", {}))
    return dict(counts)


def _strip_attributes(decl: str) -> str:
    """decl without its `__name__(...)` attributes, nested parentheses
    included."""
    while True:
        m = re.search(r"__\w+__\s*\(", decl)
        if m is None:
            return decl
        depth, i = 1, m.end()
        while depth and i < len(decl):
            depth += {"(": 1, ")": -1}.get(decl[i], 0)
            i += 1
        decl = decl[:m.start()] + decl[i:]


def kernel_names() -> list:
    """The names of the port's own CUDA kernels (its `__global__`
    functions)."""
    found = set()
    for src in sorted(CSRC.glob("*.cu*")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            end = min(i for i in (text.find("{", m.end()), text.find(";", m.end()), len(text))
                      if i >= 0)
            name = re.search(r"(\w+)\s*\(", _strip_attributes(text[m.end():end]))
            if name:
                found.add(name.group(1))
    return sorted(found)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
