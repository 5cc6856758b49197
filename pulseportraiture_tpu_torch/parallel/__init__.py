"""Batched device programs of the align pipeline (the single-device part
of pulseportraiture_tpu/parallel; the sharded fits are ROADMAP A12) and
the campaign's process helpers at world size 1 (multihost)."""

from .batch import (ALIGN_DEVICE_CHUNK, align_accumulate_archive,  # noqa: F401
                    align_accumulator_init, align_finalize,
                    use_align_device)
from .multihost import (process_allgather, process_count,  # noqa: F401
                        process_index, shard_files)
