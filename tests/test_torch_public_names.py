"""Public-name parity of the subpackages: every name a subpackage of the
JAX package exports from its ``__init__`` (read from the source, so the
JAX package is not imported) resolves on the port's subpackage of the
same name, and is not a submodule standing in for the exported object.

Missing by design (ROADMAP's re-anchor note and C7), and so left out:
- ``ops.phasor``: the JAX package exports the function; in the port the
  name stays the submodule's (``ops.phasor.phasor`` is the function);
- ``utils.host_compute``: a JAX host-placement context with no torch
  counterpart (the port's host numerics take ``device='cpu'``).
"""

import ast
import importlib
import os
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("cli", "fit", "ingest", "io", "models", "obs", "ops",
               "parallel", "pipeline", "quality", "serve", "synth",
               "timing", "tune", "utils", "viz")
MISSING_BY_DESIGN = {"ops": {"phasor"}, "utils": {"host_compute"}}


def exported(path):
    """The public names an ``__init__`` defines or imports at top level."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") and n != "*"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_match_jax(sub):
    want = exported(os.path.join(ROOT, "pulseportraiture_tpu", sub,
                                 "__init__.py"))
    port = importlib.import_module(f"pulseportraiture_tpu_torch.{sub}")
    skip = MISSING_BY_DESIGN.get(sub, set())
    assert skip <= want, (sub, skip - want)
    missing = sorted(n for n in want - skip if not hasattr(port, n)
                     or isinstance(getattr(port, n), types.ModuleType))
    assert not missing, (sub, missing)
