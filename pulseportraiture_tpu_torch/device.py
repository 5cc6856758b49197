"""The port's one device resolver and its one tri-state resolver.

Every entry point takes an explicit ``device=`` argument and resolves it
here.  The default is ``cuda``: on a host with no card the resolver
raises instead of quietly running on the CPU, so a CPU run is always
something the caller asked for (``device="cpu"``, as the tests do).

:func:`resolve_auto` is the port's counterpart of the JAX package's
``tune/capability.resolve_auto``: where the JAX package resolves an
``'auto'`` knob by "the default backend is a TPU", the port resolves it
by "the device this call runs on is CUDA".
"""

import torch

__all__ = ["KNOB_POLARITY", "resolve_auto", "resolve_device"]

# knob -> polarity of its 'auto' arm.  'cuda': auto means ON for CUDA
# devices; 'not_cuda': auto means ON everywhere except CUDA.  Only the
# knobs the ported path reads appear here; an unknown knob is a loud
# KeyError at its first 'auto' resolution.
KNOB_POLARITY = {
    "fit_fused": "cuda",    # fused DFT -> cross-spectrum kernel lane
    "fast_fit": "cuda",     # complex-free fast fit in the pipeline
    "dft_fold": "not_cuda",  # fold-symmetry half-length DFT
    "bucket_pad": "cuda",   # stream bucket channel-count coarsening
    "device_f32": "cuda",   # the complex engine runs float64 as float32
    "zap_device": "cuda",   # the batched torch zap cut (quality/excision)
    "align_device": "cuda",  # ppalign's accumulate on the align's device
    "gauss_device": "cuda",  # the batched LM engine for template trials
    "gls_device": "cuda",   # the fleet's batched GLS solve
    # an unwindowed fast fit over every harmonic through the fused
    # kernels (fit.portrait.full_spectrum_window); no config knob
    "full_spectrum": "cuda",
}


def resolve_device(device=None):
    """``torch.device`` for an entry point's ``device=`` argument.

    None means ``cuda``.  A CUDA device with no card present raises
    RuntimeError: nothing in the port falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: 'cuda' or 'cpu'")
    return dev


def resolve_auto(knob, setting, device, label=None):
    """True/False pass through; ``'auto'`` (case/space-insensitive)
    resolves through :data:`KNOB_POLARITY` against ``device``; anything
    else raises the knob's strict ValueError."""
    if setting is True or setting is False:
        return setting
    if not (isinstance(setting, str) and setting.strip().lower() == "auto"):
        raise ValueError(
            f"{label or knob} must be True, False, or 'auto'; got "
            f"{setting!r}")
    on_cuda = torch.device(device).type == "cuda"
    return on_cuda if KNOB_POLARITY[knob] == "cuda" else not on_cuda
