"""Read the JAX harness's tools (``tools/*.py``) in the tests without
running them: most run their benchmark when imported, so each is parsed
with ``ast`` and only the parts a test names are executed: the imports,
then the globals the test injects (seeded trees, tiny configs, or proxies
of the JAX modules with a keyword fixed), then the chosen top-level
``def``s and statements. Nothing in ``tools/`` changes."""
import ast
from pathlib import Path

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def parse(name: str) -> ast.Module:
    path = str(TOOLS / name)
    return ast.parse(open(path).read(), path)


class Proxy:
    """A module with some attributes replaced (e.g. a function with a
    keyword fixed by ``functools.partial``)."""

    def __init__(self, module, **over):
        self._module, self._over = module, over

    def __getattr__(self, name):
        if name in self._over:
            return self._over[name]
        return getattr(self._module, name)


def _exec(nodes, ns: dict, name: str) -> None:
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]),
                 str(TOOLS / name), "exec"), ns)


def load(name: str, defs=(), stmts=lambda node: False,
         inject=None) -> dict:
    """The namespace of tool ``name`` after its imports, ``inject`` and
    its top-level ``def``s named in ``defs`` (each must exist) and the
    top-level statements ``stmts`` selects, in file order."""
    tree = parse(name)
    ns = {}
    _exec([n for n in tree.body
           if isinstance(n, (ast.Import, ast.ImportFrom))], ns, name)
    ns.update(inject or {})
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in defs)
            or (not isinstance(n, (ast.Import, ast.ImportFrom,
                                   ast.FunctionDef)) and stmts(n))]
    assert {n.name for n in keep if isinstance(n, ast.FunctionDef)} \
        == set(defs), (name, defs)
    _exec(keep, ns, name)
    return ns


def nested_def(name: str, outer: str, inner: str, ns: dict):
    """The ``def inner`` inside the top-level ``def outer``, executed in
    ``ns`` (its decorators included)."""
    tree = parse(name)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    node = next(n for n in fn.body
                if isinstance(n, ast.FunctionDef) and n.name == inner)
    _exec([node], ns, name)
    return ns[inner]


def assigns(*targets):
    """A ``stmts`` predicate: top-level assignments to these names."""
    def pick(node):
        return isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id in targets
            for t in node.targets)
    return pick


def expr(node, ns: dict):
    """Evaluate one expression node in ``ns``."""
    return eval(compile(ast.Expression(body=node), "<tool>", "eval"), ns)


def calls(tree, func: str):
    """Every call of ``func`` (a name or ``module.attr``) in ``tree``."""
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            f = n.func
            dotted = (f.id if isinstance(f, ast.Name) else
                      f"{f.value.id}.{f.attr}" if isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name) else None)
            if dotted == func:
                out.append(n)
    return out
