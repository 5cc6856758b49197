"""The check that a run never loaded JAX or the JAX package.

Module names are compared by their whole top-level name, the part before
the first dot: ``pulseportraiture_tpu_torch`` begins with the JAX
package's name and must pass.
"""

FORBIDDEN = ("jax", "jaxlib", "flax", "pulseportraiture_tpu")


def forbidden_modules(names):
    """The forbidden top-level names among module names ``names``."""
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
