"""The port's boundary: it imports neither JAX nor nf_tpu, it runs on the
card unless asked for the CPU, and its kernel wrapper never quietly runs
the plain version for a tensor that is not on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "nf_tpu_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_imports_no_jax_and_no_nf_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'nf_tpu' or k.startswith('nf_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_port_sources_name_no_jax_or_nf_tpu_import():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+nf_tpu\b(?!_torch)"
                         r"|from\s+nf_tpu(\.|\s)|import\s+nf_tpu\.)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


@pytest.mark.parametrize("name", ["realnvp", "glow", "flow++", "resflow"])
def test_build_model_defaults_to_the_card(name):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(name, (2,), "2d", NetworkConfig(layers=2, base_filters=8))


def test_cuda_wrapper_raises_instead_of_running_the_plain_version():
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    model = build_model("realnvp", (2,), "2d", NetworkConfig(layers=2, base_filters=8),
                        device="cpu")
    stack = model.eval_program().stack
    before = dict(fs.LAUNCHES)
    # a tensor off the CPU goes to the kernel path, which refuses it here
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_stack(stack, torch.zeros(4, 2, device="meta"), "forward")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.launch(stack, torch.zeros(4, 2), inverse=False)
    assert fs.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.load("fused_stack")


@pytest.mark.parametrize("name", ["glow", "flow++"])
def test_new_wrappers_raise_instead_of_running_the_plain_version(name):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_flowpp as ff
    from nf_tpu_torch.ops.cuda import fused_stack as fs

    model = build_model(name, (2,), "2d", NetworkConfig(layers=2, base_filters=8,
                                                         mixtures=2), device="cpu")
    stack = model.eval_program().stack
    mod, run = (ff, ff.fused_flowpp) if name == "flow++" else (fs, fs.fused_stack)
    assert isinstance(stack, ff.PackedFlowpp if name == "flow++" else fs.PackedStack)
    before = {**fs.LAUNCHES, **ff.LAUNCHES}
    with pytest.raises(ValueError, match="CUDA tensor"):
        run(stack, torch.zeros(4, 2, device="meta"), "inverse")
    with pytest.raises(ValueError, match="CUDA tensor"):
        mod.launch(stack, torch.zeros(4, 2), inverse=True)
    assert {**fs.LAUNCHES, **ff.LAUNCHES} == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.load("fused_flowpp")


def test_resflow_wrapper_raises_instead_of_running_the_plain_version():
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda import _build
    from nf_tpu_torch.ops.cuda import fused_resflow as rf

    model = build_model("resflow", (2,), "2d", NetworkConfig(layers=2, base_filters=8),
                        device="cpu")
    stack = model.eval_program().stack
    assert isinstance(stack, rf.PackedResFlow)
    probes = rf.draw_unbias_probes(4, 2, torch.Generator().manual_seed(0))
    before = dict(rf.LAUNCHES)
    for direction in ("forward", "inverse", "solve"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            rf.fused_resflow(stack, torch.zeros(4, 2, device="meta"), direction, probes)
        with pytest.raises(ValueError, match="CUDA tensor"):
            rf.launch(stack, torch.zeros(4, 2), direction, probes)
    assert rf.LAUNCHES == before
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            _build.load("fused_resflow")
