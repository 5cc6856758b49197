"""The JAX check compares whole top-level module names."""

import pytest

from portbench.importcheck import forbidden_modules


@pytest.mark.parametrize("name,bad", [
    ("jax", ["jax"]), ("jax.numpy", ["jax"]), ("jaxlib.xla_client",
                                               ["jaxlib"]),
    ("flax.linen", ["flax"]), ("pulseportraiture_tpu", ["pulseportraiture_tpu"]),
    ("pulseportraiture_tpu.fit.portrait", ["pulseportraiture_tpu"]),
    ("pulseportraiture_tpu_torch", []),
    ("pulseportraiture_tpu_torch.pipeline.stream", []),
    ("jaxtyping", []), ("numpy", [])])
def test_whole_top_level_names(name, bad):
    assert forbidden_modules([name, "sys", "torch"]) == bad


def test_the_harness_and_the_port_load_no_jax():
    """In a fresh process: the harness, the port's stream lane and a run's
    helpers import nothing of JAX or the JAX package."""
    import subprocess
    import sys

    from portbench.cells import ROOT

    code = ("import sys; import portbench.harness, portbench.calibrate; "
            "import pulseportraiture_tpu_torch.pipeline.stream; "
            "from portbench.importcheck import forbidden_modules; "
            "print(forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
