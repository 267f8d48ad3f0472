#!/usr/bin/env python
"""File-driven compress/decompress benchmark with error-volume dumps.

The equivalent of the reference's Test_Compression CLI
(Test_Compression.cpp:53-230): reads a raw float32 volume (or synthesizes
the radial test volume), round-trips it at a given scale/block, reports
timings/ratio/SNR, and optionally dumps the error volume and text XZ
slices of input/output/error (:24-39,194-208).

Usage:
  python tools/test_compression.py --nz 51 --ny 101 --nx 151 [--file vol.bin]
         [--scale 1e-2] [--block 32,32,32] [--local-rms]
         [--out compressed.cvx] [--dump-error err.bin] [--dump-slices PREFIX]
         [--backend jax|native|oracle]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def dump_xz_slice(path, vol, y=None):
    """Text dump of the XZ plane at mid-y (Test_Compression.cpp:24-39)."""
    nz, ny, nx = vol.shape
    y = ny // 2 if y is None else y
    with open(path, "w") as f:
        for z in range(nz):
            for x in range(nx):
                f.write(f"{x} {z} {vol[z, y, x]:.6e}\n")
            f.write("\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--file", help="raw f32 volume (x fastest); synthetic if omitted")
    ap.add_argument("--nz", type=int, default=51)
    ap.add_argument("--ny", type=int, default=101)
    ap.add_argument("--nx", type=int, default=151)
    ap.add_argument("--scale", type=float, default=1e-2)
    ap.add_argument("--block", default="32,32,32")
    ap.add_argument("--local-rms", action="store_true")
    ap.add_argument("--backend", default="jax")
    ap.add_argument("--out", help="write the container here")
    ap.add_argument("--dump-error", help="write |in-out| as raw f32")
    ap.add_argument("--dump-slices", help="prefix for XZ-slice text dumps")
    ap.add_argument("--iters", type=int, default=1)
    args = ap.parse_args()

    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.utils import io as cio
    from cvxcompress_tpu.utils import volumes

    if args.file:
        vol = volumes.read_raw(args.file, args.nz, args.ny, args.nx)
    else:
        vol = volumes.radial_volume(args.nz, args.ny, args.nx)
    block = tuple(int(v) for v in args.block.split(","))

    best_c = best_d = float("inf")
    for _ in range(args.iters):
        t0 = time.perf_counter()
        data, ratio = cvx.compress(
            vol, args.scale, block=block, use_local_rms=args.local_rms,
            backend=args.backend,
        )
        best_c = min(best_c, time.perf_counter() - t0)
        t0 = time.perf_counter()
        out = cvx.decompress(data, backend=args.backend)
        best_d = min(best_d, time.perf_counter() - t0)

    o = vol.astype(np.float64)
    d = o - out.astype(np.float64)
    err = np.sqrt((d * d).mean()) / np.sqrt((o * o).mean())
    snr = -20 * np.log10(err) if err > 0 else float("inf")
    mc = vol.size / 1e6
    print(f"volume {vol.shape}, block {block}, scale {args.scale}, "
          f"backend {args.backend}")
    print(f"compress   {best_c*1e3:9.2f} ms  {mc/best_c:9.1f} MC/s  "
          f"ratio {ratio:.2f}:1")
    print(f"decompress {best_d*1e3:9.2f} ms  {mc/best_d:9.1f} MC/s")
    print(f"error {err:.3e}  SNR {snr:.1f} dB")

    if args.out:
        cio.save(args.out, data)
        print(f"wrote {args.out} ({data.size} bytes)")
    if args.dump_error:
        np.abs(vol - out).astype(np.float32).tofile(args.dump_error)
        print(f"wrote {args.dump_error}")
    if args.dump_slices:
        dump_xz_slice(args.dump_slices + "_input.txt", vol)
        dump_xz_slice(args.dump_slices + "_output.txt", out)
        dump_xz_slice(args.dump_slices + "_error.txt", np.abs(vol - out))
        print(f"wrote {args.dump_slices}_{{input,output,error}}.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
