#!/usr/bin/env python
"""Capture a jax.profiler trace of the compress pipeline (XProf/TensorBoard).

The analog of the reference's optional PAPI hardware-counter hooks
(CvxCompress.cpp:21-27,787-801): where the reference samples FLOP counters
around its hot loops, this captures a full device trace of the codec
stages for inspection in XProf.

Usage:
  python tools/profile_trace.py [--logdir chiprun_out/trace]
         [--nz 128 --ny 128 --nx 128] [--block 32,32,32] [--iters 3]
Then: tensorboard --logdir <logdir>  (or open with xprof)
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default="chiprun_out/trace")
    ap.add_argument("--nz", type=int, default=128)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--block", default="32,32,32")
    ap.add_argument("--scale", type=float, default=1e-2)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.utils import profiling, volumes

    block = tuple(int(v) for v in args.block.split(","))
    vol = volumes.radial_volume(args.nz, args.ny, args.nx)

    # warm up (compiles outside the trace)
    data, ratio = cvx.compress(vol, args.scale, block=block)
    cvx.decompress(data)

    with profiling.device_trace(args.logdir):
        for _ in range(args.iters):
            data, ratio = cvx.compress(vol, args.scale, block=block)
            cvx.decompress(data)

    print(f"ratio {ratio:.1f}:1; trace written to {args.logdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
