"""The import guard: no module of the benchmark imports JAX, optax, flax or
the JAX package, and the reference imports nothing of the port either. Top-
level names are compared whole (`isaacgyminsertion_tpu_torch` begins with
the JAX package's name)."""

import ast
import os

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "isaacgyminsertion_tpu"}
PORT = "isaacgyminsertion_tpu_torch"


def _modules():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_top_names(path: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_forbidden_import(path):
    names = _imported_top_names(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert PORT not in names


def test_guard_compares_whole_names(tmp_path):
    bad = tmp_path / "m.py"
    bad.write_text("import isaacgyminsertion_tpu.envs\nfrom isaacgyminsertion_tpu_torch import bench\n")
    names = _imported_top_names(str(bad))
    assert names & FORBIDDEN == {"isaacgyminsertion_tpu"} and PORT in names
