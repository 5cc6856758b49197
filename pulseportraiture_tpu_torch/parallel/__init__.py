"""Scale-out on torch.distributed (counterpart of
pulseportraiture_tpu/parallel): the rank mesh (mesh), the process group
and the campaign's helpers (multihost), the sharded fits and align
iteration and the single-device align programs (batch)."""

from .batch import (ALIGN_DEVICE_CHUNK, align_accumulate_archive,  # noqa: F401
                    align_accumulator_init, align_finalize,
                    align_iteration_sharded, fit_portrait_sharded,
                    fit_portrait_sharded_fast, shard_batch,
                    use_align_device)
from .mesh import batch_sharding, make_mesh, replicated  # noqa: F401
from .multihost import (global_mesh, init_multihost,  # noqa: F401
                        process_allgather, process_count, process_index,
                        select_backend, shard_files)
