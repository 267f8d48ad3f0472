"""NumPy oracle for the Antonini 7/9 multi-level 3D wavelet transform.

This is the correctness oracle for the device codec: a direct, trivially-auditable
implementation of the transform semantics defined by the reference's scalar
path (reference: Wavelet_Transform_Slow.cpp:71-134 forward, :201-259 inverse,
:261-301 3D drivers).  All arithmetic is float32 with the same per-element
accumulation order as the reference scalar code, so results match the
reference slow path bit-for-bit.

Contract highlights (reference file:line cites):
- Filter taps: FBI/Antonini 7/9 analysis pair (Wavelet_Transform_Slow.cpp:21-30),
  synthesis pair (:136-145).
- Boundary: chained whole-sample symmetric mirroring, MIRR (:59-67); the
  inverse uses band-local mirrors MIRR_SL (:178-188) and MIRR_SH (:189-199).
- Multi-level schedule per axis: n, n - n//2, ... down to 2, each level
  re-transforming the lowpass prefix in place (:80, :212), coefficients laid
  out [L band | H band].
- 3D composition: each axis independently fully decomposed, order x -> y -> z
  for both forward and inverse (:275-279, :296-300).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32

# Analysis lowpass (9 taps, symmetric) / highpass (7 taps).
# Wavelet_Transform_Slow.cpp:21-30
AL = np.array(
    [
        8.526986790094000e-001,
        3.774028556126500e-001,
        -1.106244044184200e-001,
        -2.384946501938001e-002,
        3.782845550699501e-002,
    ],
    dtype=F32,
)
AH = np.array(
    [
        7.884856164056601e-001,
        -4.180922732222101e-001,
        -4.068941760955800e-002,
        6.453888262893799e-002,
    ],
    dtype=F32,
)

# Synthesis lowpass / highpass. Wavelet_Transform_Slow.cpp:136-145
SL = np.array(
    [
        7.884856164056601e-001,
        4.180922732222101e-001,
        -4.068941760955800e-002,
        -6.453888262893799e-002,
    ],
    dtype=F32,
)
SH = np.array(
    [
        8.526986790094000e-001,
        -3.774028556126500e-001,
        -1.106244044184200e-001,
        2.384946501938001e-002,
        3.782845550699501e-002,
    ],
    dtype=F32,
)


def mirr(idx, n):
    """Forward-transform mirror: chained whole-sample symmetric extension.

    Reference: Wavelet_Transform_Slow.cpp:59-67 (MIRR).
    """
    v = np.abs(np.asarray(idx))
    v = np.where(v >= n, 2 * n - 2 - v, v)
    v = np.abs(v)
    v = np.where(v >= n, 2 * n - 2 - v, v)
    return v


def mirr_sl(idx, nl):
    """Inverse-transform mirror for the lowpass (SL) band.

    Reference: Wavelet_Transform_Slow.cpp:178-188 (MIRR_SL).
    """
    v = np.asarray(idx)
    for _ in range(3):
        v = np.abs(v)
        v = np.where(v >= nl, 2 * nl - 1 - v, v)
    return v


def mirr_sh(idx, nl, nh):
    """Inverse-transform mirror for the highpass (SH) band (half-offset).

    Reference: Wavelet_Transform_Slow.cpp:189-199 (MIRR_SH).
    """
    v = np.asarray(idx) - nl
    for _ in range(3):
        v = np.where(v < 0, -v - 1, v)
        v = np.where(v >= nh, 2 * nh - 2 - v, v)
    return nl + v


def level_schedule(dim):
    """Per-axis level lengths: dim, dim - dim//2, ..., 2.

    Reference: Wavelet_Transform_Slow.cpp:80 (forward), :212 (inverse builds
    the same list and replays it reversed).
    """
    out = []
    n = dim
    while n >= 2:
        out.append(n)
        n = n - n // 2
    return out


def ds79(x):
    """Full multi-level forward 1D transform along the last axis.

    Exact float32 accumulation order of Wavelet_Transform_Slow.cpp:95-124.
    """
    out = np.array(x, dtype=F32, copy=True)
    dim = out.shape[-1]
    for n in level_schedule(dim):
        t = out[..., :n].copy()
        nh = n // 2
        nl = n - nh

        i0 = 2 * np.arange(nl)
        tt = lambda off: t[..., mirr(i0 + off, n)]  # noqa: E731
        # sum smallest to largest (reference comment), order :104-109
        acc1 = AL[4] * (tt(-4) + tt(4))
        acc1 = acc1 + AL[1] * (tt(-1) + tt(1))
        acc1 = acc1 + AL[0] * t[..., i0]
        acc2 = AL[3] * (tt(-3) + tt(3))
        acc2 = acc2 + AL[2] * (tt(-2) + tt(2))
        lo = acc1 + acc2

        i0 = 2 * np.arange(nh) + 1
        tt = lambda off: t[..., mirr(i0 + off, n)]  # noqa: E731
        # order :119-122
        acc1 = AH[3] * (tt(-3) + tt(3))
        acc1 = acc1 + AH[0] * t[..., i0]
        acc2 = AH[2] * (tt(-2) + tt(2))
        acc2 = acc2 + AH[1] * (tt(-1) + tt(1))
        hi = acc1 + acc2

        out[..., :nl] = lo
        out[..., nl:n] = hi
    return out


def us79(x):
    """Full multi-level inverse 1D transform along the last axis.

    Exact float32 accumulation order of Wavelet_Transform_Slow.cpp:230-248.
    """
    out = np.array(x, dtype=F32, copy=True)
    dim = out.shape[-1]
    for n in reversed(level_schedule(dim)):
        t = out[..., :n].copy()
        nh = n // 2
        nl = n - nh

        k = np.arange(nl)
        tsl = lambda off: t[..., mirr_sl(k + off, nl)]  # noqa: E731
        tsh = lambda off: t[..., mirr_sh(nl + k + off, nl, nh)]  # noqa: E731
        # left-associative sum, order :233-237
        even = SL[0] * t[..., k]
        even = even + SL[2] * (tsl(-1) + tsl(1))
        even = even + SH[1] * (tsh(-1) + tsh(0))
        even = even + SH[3] * (tsh(-2) + tsh(1))

        k = np.arange(nh)
        tsl = lambda off: t[..., mirr_sl(k + off, nl)]  # noqa: E731
        tsh = lambda off: t[..., mirr_sh(nl + k + off, nl, nh)]  # noqa: E731
        # order :242-247
        odd = SL[1] * (tsl(0) + tsl(1))
        odd = odd + SL[3] * (tsl(-1) + tsl(2))
        odd = odd + SH[0] * t[..., nl + k]
        odd = odd + SH[2] * (tsh(-1) + tsh(1))
        odd = odd + SH[4] * (tsh(-2) + tsh(2))

        out[..., 0:n:2] = even
        out[..., 1:n:2] = odd
    return out


def _move_axis_transform(block, axis, fn):
    b = np.moveaxis(block, axis, -1)
    b = fn(b)
    return np.moveaxis(b, -1, axis)


def forward_3d(block):
    """Forward 3D transform of a (bz, by, bx) block, axis order x -> y -> z.

    Reference: Wavelet_Transform_Slow.cpp:261-280.  Axes of length 1 are
    skipped (bz == 1 supports 2D volumes, CvxCompress.hxx:62).
    """
    out = np.array(block, dtype=F32, copy=True)
    if out.shape[2] > 1:
        out = ds79(out)  # x is the last (contiguous) axis
    if out.shape[1] > 1:
        out = _move_axis_transform(out, 1, ds79)
    if out.shape[0] > 1:
        out = _move_axis_transform(out, 0, ds79)
    return out


def inverse_3d(block):
    """Inverse 3D transform, same axis order x -> y -> z.

    Reference: Wavelet_Transform_Slow.cpp:282-301 (valid because per-axis
    transforms commute).
    """
    out = np.array(block, dtype=F32, copy=True)
    if out.shape[2] > 1:
        out = us79(out)
    if out.shape[1] > 1:
        out = _move_axis_transform(out, 1, us79)
    if out.shape[0] > 1:
        out = _move_axis_transform(out, 0, us79)
    return out
