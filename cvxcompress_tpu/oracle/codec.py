"""Full NumPy oracle codec: compress/decompress with reference semantics.

Combines the oracle wavelet transform, quantizer/RLE and the container into
an end-to-end codec mirroring CvxCompress::Compress (CvxCompress.cpp:231-427)
and ::Decompress (:463-571).  Volumes are numpy arrays of shape (nz, ny, nx),
C-order, so x is the fast (contiguous) axis, matching the reference memory
layout.

This codec is the correctness oracle and format authority for the device path:
slow, obvious, and byte-exact against the grammar.
"""

from __future__ import annotations

import math

import numpy as np

from .. import container as ctn
from . import rle, wavelet

F32 = np.float32


def compute_global_rms(vol):
    """sqrt(sum(x^2)/N) with float64 accumulation (CvxCompress.cpp:73-117)."""
    v = np.asarray(vol, dtype=F32)
    acc = np.sum(np.square(v, dtype=np.float64))
    return F32(math.sqrt(acc / v.size))


def compute_local_rms(coeffs):
    """Per-block RMS of the wavelet *coefficients* (CvxCompress.cpp:119-142).

    The reference accumulates in float32 across 8 SIMD lanes; we accumulate in
    float64 (documented deviation, ~1e-7 relative on the stored mulfac — the
    container stores the mulfac actually used, so decode is self-consistent).
    """
    c = np.asarray(coeffs, dtype=F32)
    acc = np.sum(np.square(c, dtype=np.float64))
    return F32(math.sqrt(acc / c.size))


def extract_block(vol, x0, y0, z0, bx, by, bz):
    """Gather a (bz, by, bx) block, zero-padding past volume edges.

    Reference: Copy_To_Block (Block_Copy.cpp:21-116).
    """
    nz, ny, nx = vol.shape
    blk = np.zeros((bz, by, bx), dtype=F32)
    zs, ys, xs = (
        min(bz, nz - z0),
        min(by, ny - y0),
        min(bx, nx - x0),
    )
    blk[:zs, :ys, :xs] = vol[z0 : z0 + zs, y0 : y0 + ys, x0 : x0 + xs]
    return blk


def insert_block(vol, blk, x0, y0, z0):
    """Scatter a block back, clipping at volume edges.

    Reference: Copy_From_Block (Block_Copy.cpp:136-212).
    """
    nz, ny, nx = vol.shape
    bz, by, bx = blk.shape
    zs, ys, xs = min(bz, nz - z0), min(by, ny - y0), min(bx, nx - x0)
    vol[z0 : z0 + zs, y0 : y0 + ys, x0 : x0 + xs] = blk[:zs, :ys, :xs]


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False):
    """Compress a (nz, ny, nx) float32 volume. Returns (container, ratio).

    Mirrors CvxCompress::Compress (CvxCompress.cpp:231-427): global RMS ->
    mulfac, per block gather -> forward DWT -> [local RMS] -> quantize+RLE,
    raw fallback when the encoded block exceeds the raw size (:350-360).
    """
    vol = np.ascontiguousarray(vol, dtype=F32)
    nz, ny, nx = vol.shape
    bx, by, bz = block
    assert ctn.is_valid_block_size(bx, by, bz), "invalid block size"

    glob_rms = F32(1.0) if use_local_rms else compute_global_rms(vol)
    glob_mulfac = (
        F32(1.0) if use_local_rms else ctn.compute_glob_mulfac(glob_rms, scale)
    )

    nbx, nby, nbz, nnn = ctn.block_grid(nx, ny, nz, bx, by, bz)
    cells = bx * by * bz
    payloads = []
    raw_flags = []
    blkmulfac = np.ones(nnn, dtype=F32) if use_local_rms else None

    for ib in range(nnn):
        iiz, r = divmod(ib, nbx * nby)
        iiy, iix = divmod(r, nbx)
        blk = extract_block(vol, iix * bx, iiy * by, iiz * bz, bx, by, bz)
        coeffs = wavelet.forward_3d(blk)
        mulfac = glob_mulfac
        if use_local_rms:
            lrms = compute_local_rms(coeffs)
            mulfac = (
                F32(1.0) if lrms == 0.0 else ctn.compute_glob_mulfac(lrms, scale)
            )
            if not math.isfinite(float(mulfac)):
                mulfac = F32(1.0)
            blkmulfac[ib] = mulfac
        payload = rle.encode(mulfac, coeffs.ravel())
        if len(payload) > 4 * cells:  # raw fallback, CvxCompress.cpp:350-360
            payloads.append(coeffs.astype(F32).tobytes())
            raw_flags.append(True)
        else:
            payloads.append(payload)
            raw_flags.append(False)

    hdr = ctn.Header(nx, ny, nz, bx, by, bz, glob_mulfac, use_local_rms)
    data = ctn.pack(hdr, payloads, raw_flags, blkmulfac)
    ratio = (nx * ny * nz * 4) / data.size
    return data, ratio


def decompress(data):
    """Decompress a container back to a (nz, ny, nx) float32 volume.

    Mirrors CvxCompress::Decompress (CvxCompress.cpp:463-571): per block
    decode (or raw copy) -> inverse DWT -> clipped scatter.
    """
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    nbx, nby, nbz, nnn = hdr.grid
    bx, by, bz = hdr.bx, hdr.by, hdr.bz
    cells = bx * by * bz
    vol = np.empty((hdr.nz, hdr.ny, hdr.nx), dtype=F32)

    for ib in range(nnn):
        iiz, r = divmod(ib, nbx * nby)
        iiy, iix = divmod(r, nbx)
        off = int(blkoffs[ib])
        is_raw = off < 0  # MSB set
        off &= 0x7FFFFFFFFFFFFFFF
        start = payload_base + off
        if is_raw:
            # copy to guarantee 4-byte alignment before the f32 view
            coeffs = raw[start : start + 4 * cells].copy().view(F32)
            coeffs = coeffs.reshape(bz, by, bx)
        else:
            mulfac = blkmulfac[ib] if hdr.use_local_rms else hdr.glob_mulfac
            vals, _ = rle.decode(mulfac, raw[start:], cells)
            coeffs = vals.reshape(bz, by, bx)
        blk = wavelet.inverse_3d(coeffs)
        insert_block(vol, blk, iix * bx, iiy * by, iiz * bz)
    return vol
