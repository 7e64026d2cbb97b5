"""Nothing under portbench/ imports JAX or the JAX package: the top-level
name of every module, compared whole (``repro_torch`` is the port,
``repro`` the JAX package)."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(cells.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(cells.HERE)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_references_import_nothing_of_the_program():
    for path in (cells.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                for n in names:
                    assert n and not n.startswith("repro_torch"), (path, n)


def test_loaded_modules_after_importing_the_harness():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "from portbench import run, train_cell, mesh_cell, control, "
            "check, probe;"
            "from portbench import cells;"
            "[cells.metric_reader(m) for m in ('step.mfu', "
            "'kernels.flash_fwd_roofline')];"
            "cells.reference('dense');"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_whole_name_comparison(monkeypatch):
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    from portbench import run as prun
    monkeypatch.setitem(sys.modules, "repro_torch_probe", sys)
    assert prun.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert prun.forbidden_modules() == ["repro"]
