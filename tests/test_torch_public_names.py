"""Public-name parity of the two packages, read from the sources (the
JAX package is not imported):

- every name a subpackage of the JAX package exports from its
  ``__init__`` resolves on the port's subpackage of the same name, and
  is not a submodule standing in for the exported object;
- every public top-level function and class, and every public method
  of a public class, of every JAX module exists in the port's module of
  the same path (defined there or imported into it), and the port's
  function accepts each of the JAX function's parameter names (by name,
  or through ``**kwargs``).

Missing by design (ROADMAP C7), and so left out:
- ``ops.phasor``: the JAX package exports the function; in the port the
  name stays the submodule's (``ops.phasor.phasor`` is the function);
- the Pallas-only names (MISSING_NAMES_BY_DESIGN): the port's kernels
  are hand-written CUDA, run wherever fit_fused resolves on;
- the Pallas switch of ``fused_cross_spectrum`` (MISSING_PARAMS_BY_DESIGN).
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
MISSING_BY_DESIGN = {"ops": {"phasor"}}
# (module, name): public JAX names the port leaves out on purpose
MISSING_NAMES_BY_DESIGN = {
    ("ops.fused", "fused_cross_spectrum_pallas"),
    ("ops.fused", "fused_decode_cross_spectrum_pallas"),
    ("ops.fused", "use_fit_pallas"),
    ("ops.fourier", "use_matmul_dft"),
}
# (module, function): JAX parameter names the port leaves out on purpose
MISSING_PARAMS_BY_DESIGN = {
    ("ops.fused", "fused_cross_spectrum"): {"pallas"},
}
JAX_ROOT = os.path.join(ROOT, "pulseportraiture_tpu")
PORT_ROOT = os.path.join(ROOT, "pulseportraiture_tpu_torch")


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


def _modules(root):
    """Dotted module names (relative to the package) of a package tree."""
    out = []
    for dp, _, fns in os.walk(root):
        for fn in fns:
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dp, fn), root)[:-3]
                out.append(rel.replace(os.sep, "."))
    return sorted(out)


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names, a.kwarg is not None


def _surface(root, mod):
    """{name or Class.method: (params, takes **kwargs) | None} of a
    module's public functions, classes and methods, and {name: (module,
    name)} of what it imports (relative imports resolved in the
    package)."""
    path = os.path.join(root, *mod.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(root, *mod.split("."), "__init__.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    defs, imports = {}, {}
    pkg = mod.split(".")[:-1] if not path.endswith("__init__.py") \
        else mod.split(".")
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                defs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            defs[node.name] = None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not sub.name.startswith("_")
                             or sub.name == "__init__"):
                    defs[f"{node.name}.{sub.name}"] = _params(sub)
        elif isinstance(node, ast.ImportFrom) and node.level:
            base = pkg[:len(pkg) - (node.level - 1)] if node.level > 1 \
                else pkg
            src = ".".join(base + ([node.module] if node.module else []))
            for a in node.names:
                imports[a.asname or a.name] = (src, a.name)
    return defs, imports


def _resolve(root, mod, name, depth=0):
    """(params, **kwargs) of ``name`` as the port's module ``mod`` sees
    it (defined there, or imported, followed), or False when absent."""
    defs, imports = _surface(root, mod)
    if name in defs:
        return defs[name]
    head = name.split(".")[0]
    if head in imports and depth < 4:
        src, orig = imports[head]
        rest = name[len(head):]
        try:
            return _resolve(root, src, orig + rest, depth + 1)
        except FileNotFoundError:
            return False
    return False


@pytest.mark.parametrize("mod", _modules(JAX_ROOT))
def test_signatures_match_jax(mod):
    """Every public function, class and method of the JAX module exists
    in the port's module of the same path and accepts the JAX
    function's parameter names, but for the by-design lists."""
    jdefs, _ = _surface(JAX_ROOT, mod)
    missing, params = [], []
    for name, jsig in sorted(jdefs.items()):
        if (mod, name) in MISSING_NAMES_BY_DESIGN:
            continue
        tsig = _resolve(PORT_ROOT, mod, name)
        if tsig is False:
            missing.append(name)
            continue
        if jsig is None or tsig is None:
            continue
        names, kwargs = tsig
        skip = MISSING_PARAMS_BY_DESIGN.get((mod, name), set()) | {"self",
                                                                   "cls"}
        lack = [p for p in jsig[0] if p not in names and p not in skip]
        if lack and not kwargs:
            params.append((name, lack))
    assert not missing, (mod, missing)
    assert not params, (mod, params)


def test_by_design_lists_are_missing():
    """Each by-design entry names something the JAX package has and the
    port lacks (a stale entry fails here)."""
    for mod, name in MISSING_NAMES_BY_DESIGN:
        assert name in _surface(JAX_ROOT, mod)[0], (mod, name)
        assert _resolve(PORT_ROOT, mod, name) is False, (mod, name)
    for (mod, name), lack in MISSING_PARAMS_BY_DESIGN.items():
        assert lack <= set(_surface(JAX_ROOT, mod)[0][name][0])
        assert not lack & set(_resolve(PORT_ROOT, mod, name)[0])
