#!/usr/bin/env python
"""Measure the wavelet contractions' error at Precision.HIGH and HIGHEST.

For each precision, on the CI config (32^3 blocks) and 384^3 at 128^3
blocks: the worst per-block relative RMS error of the forward transform
against the oracle cascade, the same for the full round trip against the
oracle decoder, and the quality bars (relative error, SNR).  The codec
keeps one precision (ops/wavelet.FLOAT_PREC); this script swaps it per run
to measure the alternative.

Usage: python tools/precision_check.py [--sample 64]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CONFIGS = (
    ((352, 416, 320), (32, 32, 32)),
    ((384, 384, 384), (128, 128, 128)),
)


def measure(precision, shape, block, sample):
    """(forward error, round-trip error, rel error, SNR) at `precision`."""
    import jax

    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.ops import wavelet
    from cvxcompress_tpu.utils import checks, volumes

    kept = wavelet.FLOAT_PREC
    wavelet.FLOAT_PREC = precision
    jax.clear_caches()  # retrace every jit at this precision
    try:
        vol = volumes.sinusoid_volume(*shape)
        data, _ = cvx.compress(vol, 1e-2, block=block)
        out = cvx.decompress(data)
        ids = checks.sample_blocks(data, sample)
        fwd = checks.forward_error(vol, data, ids)
        rt = checks.roundtrip_error(data, out, ids)
        err, snr = checks.quality(vol, out)
    finally:
        wavelet.FLOAT_PREC = kept
        jax.clear_caches()
    return fwd, rt, err, snr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sample", type=int, default=64)
    args = ap.parse_args()

    from cvxcompress_tpu.utils import cache

    cache.enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"precision_check: needs a GPU, JAX computes on "
              f"{dev.platform}", file=sys.stderr)
        return 2
    from cvxcompress_tpu.utils.profiling import card_line

    card = card_line()
    print(f"card: {card}")
    P = jax.lax.Precision
    for shape, block in CONFIGS:
        for prec in (P.HIGH, P.HIGHEST):
            fwd, rt, err, snr = measure(prec, shape, block, args.sample)
            ok = fwd < 1e-5 and rt < 1e-5
            print(f"{shape} {block} {prec.name:8s} forward vs oracle "
                  f"{fwd:.3e}  round trip vs oracle {rt:.3e}  "
                  f"err {err:.3e}  SNR {snr:.2f} dB  "
                  f"1e-5 contract {'held' if ok else 'MISSED'}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
