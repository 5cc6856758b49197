"""Persisted tuning database (counterpart of
pulseportraiture_tpu/tune/store.py, schema version 1).

One JSON file holds the autotuner's accepted winners, keyed by (backend
fingerprint, shape class):

- **zero re-sweeps on a warm DB**: a second run with the same
  fingerprint and shape class loads the stored knobs and times no
  candidate (the trace shows ``tune_apply`` with ``db_hit`` true and no
  ``tune_sweep`` events);
- **a stale or corrupt DB is refused loudly, never fatally**: a file
  that fails to parse, has another schema version, or was measured on
  another fingerprint gives a ``warnings.warn`` and an empty store, and
  the campaign runs with the defaults.  A DB the JAX package wrote
  carries a ``jax-`` fingerprint, so the port refuses it: winners
  measured on a TPU never apply to a card;
- **atomic writes**: a temporary file and ``os.replace``.

Schema (version 1)::

    {"version": 1,
     "fingerprint": "cuda:NVIDIA H100 80GB HBM3:torch-2...",
     "entries": {"<shape_class>": {"knobs": {...},
                                   "default_s": ..., "tuned_s": ...,
                                   "n_swept": ...}}}

One file holds one fingerprint.
"""

import json
import os
import warnings

from .capability import backend_fingerprint

__all__ = ["TuningStore", "SCHEMA_VERSION"]

SCHEMA_VERSION = 1


class TuningStore:
    """Load and store tuning winners at ``path`` for the fingerprint of
    ``device`` (None: the default CUDA device), or for ``fingerprint``
    when given."""

    def __init__(self, path, fingerprint=None, device=None):
        self.path = str(path)
        self.fingerprint = (fingerprint if fingerprint is not None
                            else backend_fingerprint(device))

    def _load_raw(self):
        """The validated entries dict, or {} with a loud warning when
        the file is unreadable, corrupt, mis-versioned or measured on
        another fingerprint."""
        if not os.path.exists(self.path):
            return {}
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            warnings.warn(
                f"tuning DB {self.path!r} is unreadable/corrupt "
                f"({type(e).__name__}: {e}); ignoring it and running "
                "with default knobs (delete the file to silence this)",
                stacklevel=3)
            return {}
        if not isinstance(doc, dict) \
                or doc.get("version") != SCHEMA_VERSION \
                or not isinstance(doc.get("entries"), dict):
            version = doc.get("version") if isinstance(doc, dict) else None
            warnings.warn(
                f"tuning DB {self.path!r} has an unknown schema "
                f"(version={version!r}); ignoring it and running with "
                "default knobs", stacklevel=3)
            return {}
        if doc.get("fingerprint") != self.fingerprint:
            warnings.warn(
                f"tuning DB {self.path!r} was measured on backend "
                f"{doc.get('fingerprint')!r} but this process is "
                f"{self.fingerprint!r}; ignoring it and running with "
                "default knobs (re-run the autotune sweep here)",
                stacklevel=3)
            return {}
        return doc["entries"]

    def get(self, shape_class):
        """The stored entry dict of ``shape_class`` (``{"knobs": ...,
        ...}``) or None."""
        ent = self._load_raw().get(str(shape_class))
        if ent is not None and not isinstance(ent.get("knobs"), dict):
            warnings.warn(
                f"tuning DB {self.path!r} entry {shape_class!r} is "
                "malformed; ignoring it", stacklevel=2)
            return None
        return ent

    def put(self, shape_class, knobs, **meta):
        """Persist one sweep's winners (atomically; merged with the
        file's entries of the same fingerprint, while a file of another
        fingerprint is overwritten, as its refusal on load says)."""
        entries = self._load_raw()
        entries[str(shape_class)] = {"knobs": dict(knobs), **meta}
        doc = {"version": SCHEMA_VERSION,
               "fingerprint": self.fingerprint,
               "entries": entries}
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    def shape_classes(self):
        return sorted(self._load_raw())
