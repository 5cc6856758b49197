"""Driver status lines (the JAX package's telemetry.log without the
trace mirror: telemetry traces are not ported yet)."""

import sys


def log(msg, quiet=False, level="info"):
    """``info`` honours ``quiet`` and goes to stdout; ``warn`` goes to
    stderr and is never suppressed, so skip reasons never vanish."""
    if level not in ("info", "warn"):
        raise ValueError(f"log level must be 'info' or 'warn', "
                         f"got {level!r}")
    if level == "warn":
        print(msg, file=sys.stderr)
    elif not quiet:
        print(msg)
