"""Measure decode plan() cost at the reference's LARGE config.

The reference's big benchmark volume is 960x1248x1056 at 32^3 blocks
(SURVEY.md perf baselines; CvxCompress.cpp:528-568 does zero recurring
planning, so our recurring host plan must stay negligible at that block
count).  nnn = 30*39*33 = 38,610 blocks — 27x the CI config's 1,430.

The bar: plan cost at nnn=38,610 < 5 ms.  plan() is
O(compressed bytes) span arithmetic + one native ragged memcpy
(ops/entropy_decode.py:140-234, no per-block Python loop), so the cost
should scale with payload size, not block count.  This probe builds the
container with the NATIVE backend (host-only — runs with the GPU busy)
and times plan() with and without staging reuse.

Usage: python tools/plan_scale_probe.py [--small]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="shrunk shape for smoke-testing the probe itself")
    args = ap.parse_args()

    from cvxcompress_tpu import api
    from cvxcompress_tpu.ops import entropy_decode as ed
    from cvxcompress_tpu.utils import volumes

    if args.small:
        shape = (192, 256, 224)
    else:
        shape = (960, 1248, 1056)  # nz, ny, nx — the reference big config
    nz, ny, nx = shape
    nnn = -(-nz // 32) * -(-ny // 32) * -(-nx // 32)
    print(f"shape={shape} cells={nz*ny*nx/1e6:.0f}M nnn={nnn}",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    vol = volumes.sinusoid_volume(nz, ny, nx, periods=10)
    print(f"synth {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    data, ratio = api.compress(vol, 1e-2, block=(32, 32, 32),
                               backend="native")
    t_c = time.perf_counter() - t0
    print(f"native compress {t_c:.1f}s ratio={ratio:.0f} "
          f"container={len(data)/1e6:.2f} MB", file=sys.stderr, flush=True)
    del vol

    # warm (allocator, libc pages, the native lib load)
    p = ed.plan(data)
    assert p is not None
    nseg = p["segs"].shape[0]

    worst = 0.0
    for tag, reuse in (("cold-buffer", False), ("reused-buffer", True)):
        best = float("inf")
        for _ in range(7):
            t0 = time.perf_counter()
            p = ed.plan(data, reuse_staging=reuse)
            best = min(best, time.perf_counter() - t0)
        worst = max(worst, best)
        print(f"plan[{tag}] nnn={nnn} nseg={nseg}: {best*1e3:.2f} ms "
              f"({'PASS' if best < 5e-3 else 'FAIL'} vs the 5 ms bar)",
              flush=True)
    return 0 if worst < 5e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
