"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so the port passes), and the reference imports
nothing of the program."""
import ast
from pathlib import Path

DATA = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mfvit_tpu"}


def imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p): imports(p) & FORBIDDEN for p in DATA.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}
    # the port's own name begins with the JAX package's: compared whole
    assert "mfvit_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for p in (DATA / "reference").rglob("*.py"):
        assert imports(p) <= {"__future__", "contextlib", "math", "torch"}
