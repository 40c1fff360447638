"""Nothing of the benchmark imports JAX or the JAX package, and its plain
reference imports nothing of the program. Names are compared by their top
level whole: `mcquic_tpu_torch` is not `mcquic_tpu`."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mcquic_tpu"}


def topLevelImports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            names.add(node.args[0].value.split(".")[0])
    return names


def modules(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.relative_to(HERE).parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(HERE)): topLevelImports(p) & FORBIDDEN for p in modules(HERE)}
    assert len(found) > 20
    assert not {p: names for p, names in found.items() if names}


def test_the_reference_imports_nothing_of_the_program():
    found = {str(p.relative_to(HERE)): topLevelImports(p) for p in modules(HERE / "reference")}
    assert len(found) >= 6
    assert not {p: n for p, n in found.items() if n & (FORBIDDEN | {"mcquic_tpu_torch"})}


def test_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import mcquic_tpu_torch.models\nfrom jax import numpy\nimport flaxen\n")
    assert topLevelImports(probe) & FORBIDDEN == {"jax"}
