"""nf_tpu's public surface against the port's.

Every public top-level name of ``nf_tpu/**/*.py`` (functions, classes,
module-level constants, and the names an ``__init__.py`` re-exports),
read with ``ast`` so nothing of JAX is imported, must exist in the
counterpart module of ``nf_tpu_torch``, which is imported:
``nf_tpu/X.py`` goes to ``nf_tpu_torch/X.py`` and ``ops/pallas/X.py`` to
``ops/cuda/X.py``; ``utils/cache.py`` has none.  Otherwise the name
stands in ``JAX_ONLY`` with the reason it is not ported and the port's
counterpart (a dotted path that must import, or None).  A re-export is
covered by the entry of the name it re-exports.  Only JAX idiom and Pallas
plumbing belong in the table: a name with a behaviour of its own is
ported.

Every file of nf_tpu's ``scripts/`` stands in ``SCRIPTS``: the port's
counterpart (a dotted path that must import), or the one-line reason it
stays with the JAX package; a new script fails until it is placed.
"""
from __future__ import annotations

import ast
import functools
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# nf_tpu modules without a counterpart module in the port
NO_COUNTERPART = {"nf_tpu.utils.cache"}

_NEWTON = ("a Pallas kernel's copy of the mixture Newton solve's constant; the port "
           "keeps one copy, beside the plain solve, which the CUDA sources repeat")
_FACTORY = ("a Pallas kernel factory; nvcc builds the port's kernels "
            "(ops/cuda/_build.py) and PackedResFlow picks one by shape")

# qualified nf_tpu name -> (why it is not ported, the port's counterpart or None)
JAX_ONLY = {
    "nf_tpu.core.bijector.Ctx": (
        "JAX's per-call context: the modules' training flag, and generators and "
        "probes handed to the layers explicitly (core/bijector.py::call_forward)", None),
    "nf_tpu.core.bijector.Variables": (
        "the {'params', 'state'} pytree: the port's variables are the modules' "
        "parameters and buffers, and variable_tree builds nf_tpu's tree of them",
        "nf_tpu_torch.convert.variable_tree"),
    "nf_tpu.core.bijector.empty_variables": (
        "an empty {'params', 'state'} pytree, the variables of a layer without any",
        "nf_tpu_torch.convert.variable_tree"),
    "nf_tpu.parallel.distributed.host_key": (
        "a JAX PRNG key per host; the port seeds a torch.Generator per host",
        "nf_tpu_torch.parallel.distributed.host_seed"),
    "nf_tpu.utils.cache.enable_persistent_compile_cache": (
        "XLA's compile cache; the port's kernels build once into build/", None),
    "nf_tpu.ops.odeint.MAX_ADAPTIVE_FACTOR": (
        "a static bound on a jitted adaptive loop's masked steps; the port's "
        "adaptive loop runs on the host and needs none", None),
    "nf_tpu.ops.pallas.attention.attention": (
        "the dispatcher lives beside its plain version, above the kernel's wrapper",
        "nf_tpu_torch.ops.attention.attention"),
    "nf_tpu.ops.pallas.attention.attention_reference": (
        "the plain version lives beside the dispatcher, above the kernel's wrapper",
        "nf_tpu_torch.ops.attention.attention_reference"),
    "nf_tpu.ops.pallas.attention.attention_pallas": (
        "the Pallas call; the port's entry is the autograd Function over the kernel",
        "nf_tpu_torch.ops.cuda.attention.AttentionFwd"),
    "nf_tpu.ops.pallas.coupling.coupling_fwd_pallas": (
        "the Pallas call behind coupling_fwd", "nf_tpu_torch.ops.cuda.coupling.coupling_fwd"),
    "nf_tpu.ops.pallas.coupling.coupling_inv_pallas": (
        "the Pallas call behind coupling_inv", "nf_tpu_torch.ops.cuda.coupling.coupling_inv"),
    "nf_tpu.ops.pallas.fused_flowpp.SPAN": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.SPAN"),
    "nf_tpu.ops.pallas.fused_flowpp.N_ITERS": (
        _NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.N_ITERS"),
    "nf_tpu.ops.pallas.fused_flowpp.XTOL": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.XTOL"),
    "nf_tpu.ops.pallas.fused_flowpp.TINY": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.TINY"),
    "nf_tpu.ops.pallas.fused_flowpp.call_flowpp": (
        "the Pallas call; the port's launch runs the kernel of either direction",
        "nf_tpu_torch.ops.cuda.fused_flowpp.launch"),
    "nf_tpu.ops.pallas.fused_flowpp.fused_flowpp_forward": (
        "pack + call, one direction: fused_flowpp(stack, x, 'forward')",
        "nf_tpu_torch.ops.cuda.fused_flowpp.fused_flowpp"),
    "nf_tpu.ops.pallas.fused_flowpp.fused_flowpp_inverse": (
        "pack + call, one direction: fused_flowpp(stack, x, 'inverse')",
        "nf_tpu_torch.ops.cuda.fused_flowpp.fused_flowpp"),
    "nf_tpu.ops.pallas.fused_flowpp.make_inv_packed": (
        "the inverse's weight list of the Pallas call; PackedFlowpp holds both directions'",
        "nf_tpu_torch.ops.cuda.fused_flowpp.PackedFlowpp"),
    "nf_tpu.ops.pallas.fused_resflow.call_fwd_logdet": (
        "the Pallas call: fused_resflow(stack, x, 'forward', probes)",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.call_solve": (
        "the Pallas call: fused_resflow(stack, z, 'solve')",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.call_solve_logdet": (
        "the Pallas call: fused_resflow(stack, z, 'inverse', probes)",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.fused_resflow_forward": (
        "pack + call: PackedResFlow, then fused_resflow(stack, x, 'forward', probes)",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.fused_resflow_inverse": (
        "pack + call: PackedResFlow, then fused_resflow(stack, z, 'inverse', probes)",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.fused_resflow_inverse_solve": (
        "pack + call: PackedResFlow, then fused_resflow(stack, z, 'solve')",
        "nf_tpu_torch.ops.cuda.fused_resflow.fused_resflow"),
    "nf_tpu.ops.pallas.fused_resflow.make_fwd_logdet_kernel": (
        _FACTORY, "nf_tpu_torch.ops.cuda.fused_resflow.PackedResFlow"),
    "nf_tpu.ops.pallas.fused_resflow.make_solve_kernel": (
        _FACTORY, "nf_tpu_torch.ops.cuda.fused_resflow.PackedResFlow"),
    "nf_tpu.ops.pallas.fused_resflow.make_solve_logdet_kernel": (
        _FACTORY, "nf_tpu_torch.ops.cuda.fused_resflow.PackedResFlow"),
    "nf_tpu.ops.pallas.fused_stack.fused_stack_forward": (
        "pack + call, one direction: fused_stack(stack, x, 'forward')",
        "nf_tpu_torch.ops.cuda.fused_stack.fused_stack"),
    "nf_tpu.ops.pallas.fused_stack.fused_stack_inverse": (
        "pack + call, one direction: fused_stack(stack, x, 'inverse')",
        "nf_tpu_torch.ops.cuda.fused_stack.fused_stack"),
    "nf_tpu.ops.pallas.mixlogcdf.SPAN": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.SPAN"),
    "nf_tpu.ops.pallas.mixlogcdf.N_ITERS": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.N_ITERS"),
    "nf_tpu.ops.pallas.mixlogcdf.XTOL": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.XTOL"),
    "nf_tpu.ops.pallas.mixlogcdf.TINY": (_NEWTON, "nf_tpu_torch.bijectors.mixlogcdf.TINY"),
    "nf_tpu.ops.pallas.mixlogcdf.mix_log_cdf_inverse_pallas": (
        "the Pallas call; the port's entry is the autograd Function over the kernel",
        "nf_tpu_torch.ops.cuda.mixlogcdf.MixLogCdfInverse"),
    "nf_tpu.ops.pallas.mixlogcdf.use_pallas_bisect": (
        "the opt-in switch to the Pallas solve; the port's mix_log_cdf_inverse takes "
        "the kernel for a CUDA tensor", "nf_tpu_torch.bijectors.mixlogcdf.mix_log_cdf_inverse"),
}


_BENCH = "a bench of nf_tpu's; waits for the port's bench (bench.py too), a benchmark PR's"
_STUDY = "a finished study of nf_tpu on the TPU, its numbers recorded in the JSON it wrote"
_REFERENCE = "runs the original PyTorch reference, not nf_tpu"

# nf_tpu's scripts/ -> (why it is not ported or None, the port's counterpart or None)
SCRIPTS = {
    "eval_nll.py": (None, "nf_tpu_torch.evaluate.heldout_nll"),
    "eval_image_nll.py": (None, "nf_tpu_torch.evaluate.heldout_image_nll"),
    "bench_scaling.py": (_BENCH, None),
    "bench_trained.py": (_BENCH, None),
    "compile_profile.py": ("XLA's compile time of nf_tpu's jitted Flow++ image step (XLA "
                           "tooling; the port compiles no graph)", None),
    "extract_curve.py": ("no JAX: it reads the metrics.jsonl the port's CLI writes in the same "
                         "format, so it serves the port's runs as it is", None),
    "flowpp_slow_probe.py": (_STUDY, None),
    "image_parity.py": (_REFERENCE + " beside it on identical image data; the port is held to "
                        "nf_tpu by tests/test_torch_*.py", None),
    "img_mfu_probe.py": (_STUDY, None),
    "img_trace.py": ("a JAX profiler trace of nf_tpu's image step (TPU tooling)",
                     "nf_tpu_torch.utils.profiling.trace"),
    "maf_trajectory.py": (_STUDY, None),
    "measure_reference.py": (_REFERENCE, None),
    "regen_goldens.py": ("regenerates the goldens of nf_tpu's own tests", None),
    "reproduce_golden.py": ("a long run of nf_tpu's CLI for the reference's golden panels; the "
                            "port's CLI writes the same panels", "nf_tpu_torch.main.main"),
    "resflow_estimator_gap.py": (_STUDY, None),
    "resflow_fixpoint_probe.py": (_STUDY, None),
    "resflow_serving_profile.py": (_STUDY, None),
    "tpu_queue_r3.sh": ("a TPU work queue of an earlier round (TPU tooling)", None),
    "tpu_queue_r4.sh": ("a TPU work queue of an earlier round (TPU tooling)", None),
    "train_reference_nll.py": (_REFERENCE, None),
    "unported_kernel_bounds.py": ("bounds the kernels the port had not ported, from nf_tpu's "
                                  "shapes under jax.eval_shape; every kernel is ported", None),
    "vardequant_ab.py": (_STUDY, None),
}


def module_name(path: Path) -> str:
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


MODULES = {module_name(p): p for p in sorted((ROOT / "nf_tpu").rglob("*.py"))}


def port_module(module: str) -> str:
    name = "nf_tpu_torch" + module[len("nf_tpu"):]
    return name.replace("nf_tpu_torch.ops.pallas", "nf_tpu_torch.ops.cuda", 1)


def _top_level(body):
    """The module's statements, with those of top-level if / try blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body)
            for handler in getattr(node, "handlers", ()):
                yield from _top_level(handler.body)
            yield from _top_level(node.orelse)
            yield from _top_level(getattr(node, "finalbody", ()))
        else:
            yield node


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
            if isinstance(e, ast.Name):
                yield e.id


@functools.lru_cache(maxsize=None)
def names_of(module: str) -> dict:
    """``module``'s public top-level names, each with where it comes from:
    ('def', None) for a name defined there, ('export', (module, name)) for
    a relative import of an ``__init__.py``, (module, None) for a
    submodule it imports."""
    path = MODULES[module]
    package = module if path.name == "__init__.py" else module.rpartition(".")[0]
    names = {}
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names[node.name] = ("def", None)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names.update((n, ("def", None)) for n in _assigned(node))
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and node.level > 0):
            base = package.rsplit(".", node.level - 1)[0] if node.level > 1 else package
            for alias in node.names:
                source = ((f"{base}.{node.module}", alias.name) if node.module
                          else (f"{base}.{alias.name}", None))   # `from . import math`
                names[alias.asname or alias.name] = ("export", source)
    return {k: v for k, v in names.items() if not k.startswith("_")}


def origin(module: str, name: str) -> str:
    """The qualified name a public name of ``module`` stands for, through
    its re-exports."""
    kind, source = names_of(module)[name]
    if kind == "def":
        return f"{module}.{name}"
    src_module, src_name = source
    if src_name is None:
        return src_module
    return origin(src_module, src_name)


def resolve(dotted: str):
    """Import the longest importable module prefix of ``dotted`` and walk
    the rest as attributes."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_the_walk_sees_the_package():
    """The AST walk finds nf_tpu's modules and the names of each kind."""
    assert len(MODULES) > 60 and "nf_tpu.ops.pallas.fused_stack" in MODULES
    assert names_of("nf_tpu.bijectors")["Squeeze1d"] == (
        "export", ("nf_tpu.bijectors.squeeze", "Squeeze1d"))
    assert names_of("nf_tpu.ops.odeint")["MAX_ADAPTIVE_FACTOR"] == ("def", None)
    assert origin("nf_tpu", "Ctx") == "nf_tpu.core.bijector.Ctx"
    assert origin("nf_tpu.ops", "math") == "nf_tpu.ops.math"


@pytest.mark.parametrize("module", sorted(MODULES))
def test_every_public_name_has_a_counterpart(module):
    port = None if module in NO_COUNTERPART else importlib.import_module(port_module(module))
    missing = []
    for name in sorted(names_of(module)):
        if port is not None and hasattr(port, name):
            continue
        if f"{module}.{name}" in JAX_ONLY or origin(module, name) in JAX_ONLY:
            continue
        missing.append(name)
    assert not missing, (f"{module}: {missing} have no counterpart in "
                         f"{port_module(module)} and no JAX_ONLY entry")


@pytest.mark.parametrize("qualified", sorted(JAX_ONLY))
def test_jax_only_entry_is_live(qualified):
    """The entry names a public nf_tpu name the port's module lacks, gives a
    one-line reason, and its counterpart imports."""
    reason, counterpart = JAX_ONLY[qualified]
    module, _, name = qualified.rpartition(".")
    assert name in names_of(module), f"{qualified} is no public name of nf_tpu"
    if module not in NO_COUNTERPART:
        port = importlib.import_module(port_module(module))
        assert not hasattr(port, name), f"{qualified} is ported: drop its JAX_ONLY entry"
    assert reason and "\n" not in reason
    if counterpart is not None:
        assert counterpart.startswith("nf_tpu_torch.")
        resolve(counterpart)


SCRIPT_FILES = sorted(p.name for p in (ROOT / "scripts").iterdir() if p.is_file())


@pytest.mark.parametrize("name", SCRIPT_FILES)
def test_every_script_is_placed(name):
    """The script has a counterpart in the port, which imports, or a
    one-line reason it stays with the JAX package."""
    assert name in SCRIPTS, f"scripts/{name} is in no SCRIPTS entry"
    reason, counterpart = SCRIPTS[name]
    assert reason is not None or counterpart is not None
    assert reason is None or (reason and "\n" not in reason)
    if counterpart is not None:
        assert counterpart.startswith("nf_tpu_torch.")
        assert callable(resolve(counterpart))


def test_scripts_table_names_only_scripts():
    assert sorted(SCRIPTS) == SCRIPT_FILES
