"""No module of the benchmark imports JAX or nf_tpu (top-level names compared
whole: the port's nf_tpu_torch is not nf_tpu), and the references import
nothing of the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def _imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_nf_tpu(path):
    tops = {name.split(".")[0] for name in _imported(path)}
    assert not tops & {"jax", "jaxlib", "flax", "nf_tpu"}, tops


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imported(path)}
    assert "nf_tpu_torch" not in tops, tops


def test_the_guard_compares_whole_names():
    src = "import nf_tpu_torch.models\nfrom nf_tpu_torch import x\nimport jaxtyping\n"
    tree = ast.parse(src)
    tops = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    assert tops & {"jax", "nf_tpu"} == set()
