"""The port's imports point one way: config -> ops -> graphs -> ckks ->
api -> the tools (convert, entry, sweep, adapter, parallel/dryrun).

Every module's imports are read with ast, those inside functions too, so
a lazy import that dodges a cycle counts like any other.  No module below
the API imports ``api`` or ``convert``, the helper that hands the JAX
side's inputs to the port."""

import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "seal_embedded_tpu_torch"
NAME = PKG.name
ABOVE = (f"{NAME}.api", f"{NAME}.convert")
BELOW = sorted(
    p for p in PKG.rglob("*.py")
    if p.relative_to(PKG).parts[0] in ("ops", "ckks", "utils", "io", "golden")
    or p.name in ("graphs.py", "config.py") and p.parent == PKG)


def _module(path: pathlib.Path, root: pathlib.Path) -> str:
    parts = path.relative_to(root.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def imports(path: pathlib.Path, root: pathlib.Path = PKG) -> set[str]:
    """The modules `path` (a module of the package at `root`) imports, at
    its top and inside its functions: for ``from X import a`` both X and
    X.a (a may be a submodule)."""
    pkg = _module(path, root)
    if path.name != "__init__.py":
        pkg = pkg.rpartition(".")[0]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")
                up = ".".join(parts[:len(parts) - node.level + 1])
                base = f"{up}.{base}" if base else up
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _reaches_up(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ABOVE)


def test_the_reader_sees_relative_and_lazy_imports(tmp_path):
    """The reader resolves relative imports, both forms, at any depth."""
    mod = tmp_path / NAME / "ckks" / "x.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("from ..config import CUDA\n"
                   "def f():\n"
                   "    from .. import api\n"
                   "    from ..convert import to_device\n")
    got = imports(mod, tmp_path / NAME)
    assert {f"{NAME}.config", f"{NAME}.api", f"{NAME}.convert"} <= got
    assert sum(map(_reaches_up, got)) == 3


@pytest.mark.parametrize("path", BELOW,
                         ids=[str(p.relative_to(PKG)) for p in BELOW])
def test_no_module_below_the_api_imports_api_or_convert(path):
    up = sorted(n for n in imports(path) if _reaches_up(n))
    assert not up, f"{path.relative_to(PKG)} imports {up}"


def test_convert_imports_api_and_graphs_at_its_top():
    """convert sits above the API: it imports api and graphs at module
    level, and nothing inside a function."""
    tree = ast.parse((PKG / "convert.py").read_text())
    top = {n.module for n in tree.body if isinstance(n, ast.ImportFrom)}
    assert {"api", "graphs"} <= top
    lazy = [n for f in tree.body if isinstance(f, ast.FunctionDef)
            for n in ast.walk(f) if isinstance(n, (ast.Import,
                                                   ast.ImportFrom))]
    assert not lazy
