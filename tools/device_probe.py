#!/usr/bin/env python
"""Probe the accelerator and report codec-relevant capabilities.

The analog of the reference's CPUID feature probe
(check_4th_gen_intel_core_features.cpp:46-92): instead of AVX2/FMA/BMI
bits, reports the JAX backend, device inventory, the platform the codec
decides on and its decompress engine, and a tiny compile smoke test.

Usage: python tools/device_probe.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    print(f"jax {jax.__version__}, backend: {jax.default_backend()}")
    for i, d in enumerate(jax.devices()):
        print(f"  device[{i}]: {d.device_kind} (platform {d.platform})")

    from cvxcompress_tpu.ops import codec

    print(f"codec platform: {codec.platform()}, "
          f"decompress engine: {codec.auto_engine()}")

    x = jnp.arange(8.0)
    ok = bool(np.allclose(np.asarray(jax.jit(lambda a: a * 2)(x)), 2 * np.arange(8.0)))
    print(f"compile smoke test: {'ok' if ok else 'FAILED'}")

    try:
        from cvxcompress_tpu.ops import rle_host

        print(f"native host codec: {'available' if rle_host.available() else 'not built'}")
    except Exception as e:  # pragma: no cover
        print(f"native host codec: unavailable ({e})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
