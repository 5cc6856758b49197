#!/usr/bin/env python3
"""The stream path's cost of padding partial buckets, parent against
change, on one card.

    python3 tools/stream_pad_ab.py PARENT_TREE

PARENT_TREE is an unpacked checkout of the commit before the padding
(``git archive <commit> | tar -x -C build/parent``).  Writes the stream
path's archives once (chip_smoke.phase_main_path and stream_archives:
8 2-bit archives of 64 x 512 x 2048 and the int16 main archive, whose
64 subints are a partial bucket of nsub_batch 256), then runs each tree
in its own process in the order parent, change, change, parent: one
warm-up call of ``stream_wideband_TOAs(nsub_batch=256)``, three timed
calls (wall, TOAs/s) and one under torch.profiler (device busy time).
Prints one ``AB`` line per process and the card's name and power
limit.
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import os, sys, time
sys.path.insert(0, os.getcwd())
import torch, chip_smoke as C
from torch.profiler import ProfilerActivity, profile
from pulseportraiture_tpu_torch.ops import fused as F
from pulseportraiture_tpu_torch.pipeline.stream import stream_wideband_TOAs
torch.backends.cuda.matmul.allow_tf32 = False
F.build_kernels(verbose=False)
meta, gm = sys.argv[1], sys.argv[2]
stream_wideband_TOAs(meta, gm, nsub_batch=256, quiet=True, device='cuda')
walls = []
for _ in range(3):
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = stream_wideband_TOAs(meta, gm, nsub_batch=256, quiet=True,
                             device='cuda')
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    t = time.perf_counter()
    stream_wideband_TOAs(meta, gm, nsub_batch=256, quiet=True,
                         device='cuda')
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
busy, rows = C.profile_rows(prof)
print('AB', os.getcwd(), 'walls', [round(w, 4) for w in walls], 'TOAs/s',
      [round(len(r.TOA_list) / w, 1) for w in walls], 'h2d', r.h2d_bytes,
      'busy_ms', round(busy, 3), 'wall_ms', round(wall_ms, 3), flush=True)
"""


def main(parent):
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    from pulseportraiture_tpu_torch.ops import fused as F

    C.WORK = os.path.join(ROOT, "build", "stream_pad_ab")
    os.makedirs(C.WORK, exist_ok=True)
    F.build_kernels(verbose=False)
    print(C.card_line(), flush=True)
    C.phase_main_path()
    meta, _, _, gmodel = C.stream_archives()
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    for tag in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, "-c", RUN, meta, gmodel],
                           cwd=trees[tag], capture_output=True, text=True,
                           timeout=600)
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("AB")]
        print(tag, lines, r.stderr[-1500:] if r.returncode else "",
              flush=True)
        if r.returncode:
            return 1
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
