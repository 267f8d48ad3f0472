"""Checks of the device codec against the NumPy oracle, on what a run made.

Each check takes a container the codec produced and compares one stage
with the oracle (cvxcompress_tpu.oracle) on a sample of its blocks:

  * forward transform: the device's own unscaled coefficients vs the
    oracle's scalar cascade (the reference's 1e-5 contract,
    CvxCompress.cpp:597);
  * entropy stage: the oracle encoder, fed the device's own scaled
    coefficients, must reproduce each block's payload bytes exactly;
  * entropy decode: the device parse and the host decoder must give
    bit-identical coefficient planes;
  * round trip: oracle decode + oracle inverse of each block vs the
    decompressed volume.

chip_smoke.py runs them at the reference's sizes on the GPU; the tests run
them at small sizes on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import container as ctn
from ..oracle import codec as ocodec
from ..oracle import rle as orle
from ..oracle import wavelet as owav

F32 = np.float32


def sample_blocks(data, k, seed=0):
    """Up to k distinct block ids of the container, sorted (seeded)."""
    nnn = ctn.unpack(data)[0].grid[3]
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(nnn, size=min(int(k), nnn), replace=False))


def block_spans(data):
    """(start, size, is_raw) arrays: each block's payload within `data`."""
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    offs64 = np.asarray(blkoffs, dtype=np.int64)
    is_raw = offs64 < 0
    offs = offs64 & ~ctn.RAW_FLAG
    order = np.argsort(offs, kind="stable")
    ends = np.empty_like(offs)
    ends[order[:-1]] = offs[order[1:]]
    ends[order[-1]] = np.asarray(data).size - ctn.SLACK_BYTES - pbase
    return pbase + offs, ends - offs, is_raw


def _geometry(data):
    from ..ops import rle_device

    hdr = ctn.unpack(data)[0]
    block = (hdr.bx, hdr.by, hdr.bz)
    cells = hdr.bx * hdr.by * hdr.bz
    return hdr, block, cells, rle_device.chunk_cells(cells)


def _volume_block(vol, hdr, b):
    """Block b of a host volume, zero-padded at the edges (oracle layout)."""
    nbx, nby = hdr.grid[0], hdr.grid[1]
    iz, r = divmod(int(b), nbx * nby)
    iy, ix = divmod(r, nbx)
    return ocodec.extract_block(
        vol, ix * hdr.bx, iy * hdr.by, iz * hdr.bz, hdr.bx, hdr.by, hdr.bz
    )


def forward_error(vol, data, block_ids):
    """Worst per-block relative RMS error of the device's forward transform
    (the unscaled coefficients codec.compress used) against the oracle
    cascade, over the sampled blocks."""
    from ..ops import codec

    hdr, block, cells, chunk = _geometry(data)
    coeffs = codec._raw_chunks(jnp.asarray(vol, jnp.float32), block, chunk)
    got = np.asarray(
        coeffs.reshape(-1, cells)[jnp.asarray(block_ids, jnp.int32)]
    )
    vol_h = np.asarray(vol, dtype=F32)
    worst = 0.0
    for i, b in enumerate(block_ids):
        want = owav.forward_3d(_volume_block(vol_h, hdr, b)).ravel()
        den = np.sqrt(np.mean(want.astype(np.float64) ** 2))
        if den > 0:
            num = np.sqrt(np.mean((got[i] - want).astype(np.float64) ** 2))
            worst = max(worst, num / den)
    return worst


def entropy_mismatches(vol, data, scale, block_ids):
    """Sampled blocks whose payload bytes differ from the oracle encoder fed
    the device's own scaled coefficients (raw blocks: from its unscaled
    coefficients).  Runs the same compiled stage as codec.compress, with
    the container's own mulfac.  Returns the list of differing block ids."""
    from ..ops import codec

    hdr, block, cells, chunk = _geometry(data)
    use_local = bool(hdr.use_local_rms)
    vol_d = jnp.asarray(vol, jnp.float32)
    ids = jnp.asarray(block_ids, jnp.int32)
    _, fv, mf = codec._stage_w(
        vol_d, jnp.float32(hdr.glob_mulfac), jnp.float32(scale), use_local,
        block, chunk,
    )
    fv_h = np.asarray(fv.reshape(-1, cells)[ids])
    starts, sizes, is_raw = block_spans(data)
    raw_h = None
    if is_raw[np.asarray(block_ids)].any():
        raw_h = np.asarray(
            codec._raw_chunks(vol_d, block, chunk).reshape(-1, cells)[ids]
        )
    blkmf = ctn.unpack(data)[2]
    mf_h = np.asarray(mf)
    buf = np.asarray(data, dtype=np.uint8)
    bad = []
    for i, b in enumerate(block_ids):
        got = buf[starts[b]:starts[b] + sizes[b]].tobytes()
        if is_raw[b]:
            want = raw_h[i].astype(F32).tobytes()
        else:
            want = orle.encode(F32(1.0), fv_h[i])
        same_mf = (not use_local) or blkmf[b].view(np.uint32) == F32(
            mf_h[b]
        ).view(np.uint32)
        if got != want or not same_mf:
            bad.append(int(b))
    return bad


def _host_plane(data):
    """Host-decoded coefficients as the padded volume-order decode plane."""
    from ..ops import codec, wavelet

    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    coeffs = codec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)
    nbx, nby, nbz, _ = hdr.grid
    nbx2 = wavelet.padded_nbx(nbx, hdr.bx)
    b6 = coeffs.reshape(nbz, nby, nbx, hdr.bz, hdr.by, hdr.bx)
    plane = np.zeros((nbz, hdr.bz, nby, hdr.by, nbx2, hdr.bx), F32)
    plane[:, :, :, :, :nbx] = b6.transpose(0, 3, 1, 4, 2, 5)
    return plane.reshape(nbz * hdr.bz * nby * hdr.by, nbx2 * hdr.bx)


def _device_plane(data):
    """The device parse's padded volume-order coefficient plane."""
    from ..ops import entropy_decode as ed

    p = ed.plan(data)
    hdr = p["hdr"]
    vol_shape = (hdr.nz, hdr.ny, hdr.nx)
    block = (hdr.bx, hdr.by, hdr.bz)
    plane = ed.decode_to_volume(
        jnp.asarray(p["segs"]), jnp.asarray(p["sub_block"]),
        jnp.asarray(p["sub_reset"]), jnp.asarray(p["scalefac"]),
        vol_shape, block, p["segs"].shape[0],
    )
    if p["raw_ids"].size:
        plane = ed.overlay_raw(
            plane, jnp.asarray(p["raw_rows"]), jnp.asarray(p["raw_ids"]),
            vol_shape, block,
        )
    return np.asarray(plane)


def decoders_agree(data):
    """True when the device parse and the host decoder give bit-identical
    coefficient planes for the container."""
    a = _device_plane(data)
    b = _host_plane(data)
    return a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32)
    )


def roundtrip_error(data, out, block_ids):
    """Worst per-block relative RMS error of a decompressed volume `out`
    against the oracle decoder (oracle entropy decode + oracle inverse)."""
    hdr = ctn.unpack(data)[0]
    blkmf = ctn.unpack(data)[2]
    cells = hdr.bx * hdr.by * hdr.bz
    starts, sizes, is_raw = block_spans(data)
    buf = np.asarray(data, dtype=np.uint8)
    out = np.asarray(out)
    nbx, nby = hdr.grid[0], hdr.grid[1]
    worst = 0.0
    for b in block_ids:
        s = starts[b]
        if is_raw[b]:
            coeffs = buf[s:s + 4 * cells].copy().view(F32)
        else:
            mf = blkmf[b] if hdr.use_local_rms else hdr.glob_mulfac
            coeffs, _ = orle.decode(mf, buf[s:s + sizes[b] + 8], cells)
        want = owav.inverse_3d(coeffs.reshape(hdr.bz, hdr.by, hdr.bx))
        iz, r = divmod(int(b), nbx * nby)
        iy, ix = divmod(r, nbx)
        z0, y0, x0 = iz * hdr.bz, iy * hdr.by, ix * hdr.bx
        got = out[z0:z0 + hdr.bz, y0:y0 + hdr.by, x0:x0 + hdr.bx]
        want = want[:got.shape[0], :got.shape[1], :got.shape[2]]
        den = np.sqrt(np.mean(want.astype(np.float64) ** 2))
        if den > 0:
            num = np.sqrt(np.mean((got - want).astype(np.float64) ** 2))
            worst = max(worst, num / den)
    return worst


def quality(orig, recon):
    """(relative RMS error, SNR in dB) — Test_With_Generated_Input.cpp:98-115.
    Computed on the device when both volumes live there."""
    o = jnp.asarray(orig, jnp.float32)
    d = o - jnp.asarray(recon, jnp.float32)
    err = float(jnp.sqrt(jnp.mean(d * d)) / jnp.sqrt(jnp.mean(o * o)))
    snr = -20.0 * np.log10(err) if err > 0 else float("inf")
    return err, snr
