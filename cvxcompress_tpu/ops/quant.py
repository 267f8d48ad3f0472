"""RMS reductions and the quantization contract on device.

Global RMS contract (CvxCompress.cpp:73-117): float64 accumulation of sum of
squares, sqrt, cast to float32.  Device f64 is slow or absent, so the
framework contract is: per-shard partial sums are computed where the data lives and the
final f64 accumulation happens on host — identical math for the single-chip
and multi-host paths (the distributed layer all-reduces the same partials).
At API entry the volume is host-resident, so the single-process path simply
runs the f64 reduction in NumPy (bit-matching the oracle backend).

Quantization (Run_Length_Encode_Slow.cpp:203-207): i = trunc(mulfac * c)
toward zero with AVX cvttps semantics — NaN / out-of-int32-range map to
INT32_MIN.  A coefficient is zero iff |mulfac*c| < 1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

INT32_MIN = -2147483648


def global_rms_host(vol):
    """Reference-exact global RMS on host (float64 accumulation)."""
    v = np.asarray(vol, dtype=np.float32)
    acc = np.sum(np.square(v, dtype=np.float64))
    return np.float32(np.sqrt(acc / v.size))


def sumsq_f32(x):
    """Device partial: float32 tree-reduced sum of squares (for psum paths)."""
    return jnp.sum(jnp.square(x.astype(jnp.float32)))


def local_rms(coeff_blocks):
    """Per-block RMS of wavelet coefficients (CvxCompress.cpp:119-142,343-348).

    Input (N, bz, by, bx) -> (N,) float32.  Float32 tree accumulation on
    device (the reference also accumulates in f32, in SIMD-lane order).
    """
    n = coeff_blocks.shape[-1] * coeff_blocks.shape[-2] * coeff_blocks.shape[-3]
    ss = jnp.sum(
        jnp.square(coeff_blocks.reshape(coeff_blocks.shape[0], -1)), axis=-1
    )
    return jnp.sqrt(ss / n)


def mulfac_from_rms(rms, scale):
    """mulfac = 1/(rms*scale) with the 0/Inf guards (CvxCompress.cpp:291-295).

    Works elementwise on device arrays (local-RMS mode) and scalars.
    """
    rms = jnp.asarray(rms, dtype=jnp.float32)
    mf = jnp.float32(1.0) / (rms * jnp.float32(scale))
    mf = jnp.where(rms == 0.0, jnp.float32(1.0), mf)
    return jnp.where(jnp.isfinite(mf), mf, jnp.float32(1.0))


def quantize(coeffs, mulfac):
    """(fvals, ivals) with cvttps truncation semantics.

    `coeffs` (..., cells) f32, `mulfac` broadcastable f32.
    """
    fv = (jnp.asarray(mulfac, jnp.float32) * coeffs).astype(jnp.float32)
    in_range = (fv >= jnp.float32(-2147483648.0)) & (fv < jnp.float32(2147483648.0))
    tr = jnp.trunc(jnp.where(in_range, fv, 0.0))
    iv = jnp.where(in_range, tr.astype(jnp.int32), jnp.int32(INT32_MIN))
    return fv, iv


def dequant_scalefac(mulfac):
    """scalefac = 1.0f / mulfac (f32 divide, Run_Length_Encode_Slow.cpp:392)."""
    return (jnp.float32(1.0) / jnp.asarray(mulfac, jnp.float32)).astype(jnp.float32)
