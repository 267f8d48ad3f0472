"""The single-process codec: device compute, host container IO.

Compress pipeline (CvxCompress::Compress semantics, CvxCompress.cpp:231-427):

  host:   f64 global RMS  ->  mulfac (exact reference math)
  device: PASS 1  forward wavelet -> [local RMS] -> tokenize
          (per-cell descriptors + per-chunk byte accounting)
  host:   capacity buckets (the first volume of a stream reads the counts)
  device: PASS 2  active-chunk row-gather -> byte-plane staging ->
          log-shift front-pack -> live 64B subrows (d2h ∝ compressed size)
  host:   ragged concat -> container (header + offset table + payload)

Decompress has two engines, which share the expand and the inverse:
  "device": container parse + a segment memcpy on host (∝ compressed
            size), then ONE device program runs the entropy parse
            (ops/entropy_decode), the volume-order scatter-expand and the
            inverse wavelet;
  "host":   native C++ (or oracle) entropy decode on the host, a
            chunk-sparse upload, then the device expand + inverse.
`decompress(engine="auto")` takes the engine measured faster on the
platform the process computes on (`auto_engine`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import container as ctn
from . import blocks as blk
from . import quant, rle_device, wavelet

F32 = np.float32

# host-side cost of the most recent compress() call (seconds): the ragged
# payload concat + container packing.  Populated for observability/bench
# reporting (the device pipeline time is measured separately).
last_host_assembly_s = 0.0


@functools.cache
def platform():
    """Platform of the devices this process computes on ("gpu", "cpu").

    Read once, from the devices every jit of the codec runs on.  It is the
    codec's only platform decision (see `auto_engine`)."""
    return jax.devices()[0].platform


# decompress(engine="auto") per platform: the engine measured faster at
# the CI config on that platform (PERF.md, findings; tools/stage_times.py).
# Every other platform takes the host engine.
AUTO_ENGINE = {"gpu": "device"}


def auto_engine():
    """The decompress engine `decompress(engine="auto")` runs here."""
    return AUTO_ENGINE.get(platform(), "host")


@functools.partial(jax.jit, static_argnames=("use_local", "block", "chunk"))
def _stage_w(vol, glob_mulfac, scale, use_local, block, chunk):
    """Wavelet stage: vol (nz,ny,nx) -> (fv_rows, fv_chunks, mf).

    Emits PRE-SCALED (mulfac * coeff) coefficients in BOTH downstream
    layouts as jit outputs: tokenize's (nrows, row) compute layout and
    pack/gather's (nchunks, chunk) layout.
    """
    coeffs = wavelet.forward_3d_blocked(vol, vol.shape, block)
    n = coeffs.shape[0]
    if use_local:
        # per-block RMS of the COEFFICIENTS (CvxCompress.cpp:343-348)
        mf = quant.mulfac_from_rms(quant.local_rms(coeffs), scale)
    else:
        mf = jnp.broadcast_to(glob_mulfac, (n,)).astype(jnp.float32)
    coeffs2d = coeffs.reshape(n, -1)
    cells = coeffs2d.shape[1]
    fv2d = (coeffs2d * mf[:, None]).astype(jnp.float32)
    return (
        rle_device.as_rows(fv2d),
        fv2d.reshape(n * (cells // chunk), chunk),
        mf,
    )


def _encode_device(vol_dev, glob_mulfac, scale, use_local, block, chunk):
    """W + T stages: forward wavelet, then tokenize.

    Returns (coeff_chunks, desc, chunk_bytes, sizes, raw, counts, mf).
    """
    rows, chunks, mf = _stage_w(
        vol_dev, glob_mulfac, scale, use_local, block, chunk
    )
    desc, cb, sizes, raw, counts = rle_device.tokenize_desc(
        rows, mf.shape[0], chunk
    )
    return chunks, desc, cb, sizes, raw, counts, mf


@jax.jit
def _bundle_outputs(subrows, aidx, abytes, sizes, raw, counts, mf):
    """Serialize the pack outputs into ONE u8 buffer (one d2h fetch).

    `mf` (the per-block mulfacs) rides along so the local-RMS container
    assembly never pays a second fetch."""
    def u8(x):
        if x.dtype == jnp.uint8:
            return x.reshape(-1)
        if x.dtype == jnp.bool_:
            return x.astype(jnp.uint8)
        return jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(-1)

    return jnp.concatenate(
        [u8(counts), u8(sizes), u8(raw), u8(aidx), u8(abytes), u8(mf),
         u8(subrows)]
    )


def _split_blob(blob, sh):
    """Host split of the fetched bundle (see _bundle_outputs' layout).

    `sh` is the shapes dict a _compress_stage ctx carries."""
    nc, n, na, nb = sh["nc"], sh["n"], sh["na"], sh["nb"]
    oc = 4 * nc
    o0 = oc + 4 * n
    o1 = o0 + n
    o2 = o1 + 4 * na
    o3 = o2 + 4 * nb
    o4 = o3 + 4 * n  # mf f32 (n,)
    counts_h = blob[:oc].view(np.int32)
    sizes_h = blob[oc:o0].view(np.int32)
    raw_h = blob[o0:o1].view(np.bool_)
    aidx_h = blob[o1:o2].view(np.int32)
    abytes_h = blob[o2:o3].view(np.int32)
    mf_h = blob[o3:o4].view(np.float32)
    subrows_h = blob[o4:].reshape(sh["subrows"])
    return subrows_h, aidx_h, abytes_h, sizes_h, raw_h, counts_h, mf_h


# Sticky capacity buckets per (shape, block, mode): a stream of similar
# volumes (the RTM snapshot shape) reuses the previous volume's caps and
# skips the counts readback's round trip — the bundle carries the actual
# counts, and a cap overflow (rare: the stream's content jumped) repacks
# with exact caps.  Caps only PAD device work, never change the stream.
_CAPS_CACHE = {}


def _derive_caps(counts_h):
    acount, lcount = int(counts_h[0]), int(counts_h[1])
    return (
        rle_device.bucket(acount), rle_device.bucket(lcount),
        acount == lcount,
    )


def _caps_ok(counts_h, caps):
    acount, lcount = int(counts_h[0]), int(counts_h[1])
    if acount > caps[0] or lcount > caps[1]:
        return False
    # skip_squeeze=True is only valid when every active chunk fits one
    # subrow; a False flag is always correct (just not the fast path)
    return (not caps[2]) or acount == lcount


@jax.jit
def _gather_rows(mat, idx):
    return jnp.take(mat, idx, axis=0)


@jax.jit
def _mulfac_dev(vol, scale):
    """Global mulfac computed ON DEVICE — no host round trip per volume.

    f32 Σx² + f32 sqrt with the Inf/0 guards of compute_glob_mulfac
    (CvxCompress.cpp:291-295).  Device-resident volumes already deviate
    from the host f64-accumulation contract by ~1 ulp of RMS (documented
    in compress()); the f32 sqrt adds at most one more ulp.  The header
    value returns to the host inside the output bundle (mf[0]), so the
    whole compress path has exactly ONE d2h fetch."""
    ss = jnp.sum(jnp.square(vol))
    rms = jnp.sqrt(ss / vol.size)
    mf = jnp.float32(1.0) / (rms * jnp.float32(scale))
    ok = (rms != 0.0) & jnp.isfinite(mf)
    return jnp.where(ok, mf, jnp.float32(1.0))


@functools.partial(jax.jit, static_argnames=("block", "chunk"))
def _raw_chunks(vol, block, chunk):
    """Unscaled coefficient chunks (raw-fallback payload source, rare)."""
    coeffs = wavelet.forward_3d_blocked(vol, vol.shape, block)
    n = coeffs.shape[0]
    return coeffs.reshape(n, -1).reshape(-1, chunk)


def _prep_vol(vol):
    if isinstance(vol, jax.Array):
        return vol.astype(jnp.float32)
    return np.ascontiguousarray(vol, dtype=F32)


def _prep_mulfac(vol, scale, use_local_rms, glob_mulfac):
    """Resolve the global quantization factor for one prepared volume.

    Host volumes use the exact reference contract (f64-accumulated RMS,
    Compute_Global_RMS, CvxCompress.cpp:73-117).  DEVICE volumes return a
    device f32 scalar with NO host round trip (_mulfac_dev) — the header
    value comes back inside the output bundle.
    """
    if use_local_rms:
        return F32(1.0)
    if glob_mulfac is not None:
        return F32(glob_mulfac)
    if isinstance(vol, jax.Array):
        return _mulfac_dev(vol, scale)
    return ctn.compute_glob_mulfac(quant.global_rms_host(vol), scale)


def _compress_stage(vol, scale, block, use_local_rms, glob_mulfac):
    """Dispatch the device compress pipeline for ONE volume (async).

    Returns a ctx dict: `bundle` is the single u8 device output buffer;
    the rest is what the host finisher needs — the split geometry, the
    caps used, a repack closure for cap overflows, and the device volume
    handle for the rare raw-fallback path.  The caller fetches `bundle`
    (alone, or concatenated across a batch — compress_many's one-fetch
    trick) and hands the bytes to _compress_finish.
    """
    bx, by, bz = block
    assert ctn.is_valid_block_size(bx, by, bz), "invalid block size"
    cells = bx * by * bz
    chunk = rle_device.chunk_cells(cells)
    block = (bx, by, bz)

    def encode():
        return _encode_device(
            jnp.asarray(vol), jnp.float32(glob_mulfac), jnp.float32(scale),
            use_local_rms, block, chunk,
        )

    def pack(ck, dsc, cb, caps):
        return rle_device.pack_active(
            ck, dsc, cb, caps[0], caps[1], skip_squeeze=caps[2]
        )

    coeff_chunks, desc, chunk_bytes, sizes, raw, counts, mf = encode()
    # sticky caps: only the stream's FIRST volume (or a cap overflow)
    # pays the counts readback round trip
    cap_key = (tuple(vol.shape), block, bool(use_local_rms), chunk)
    caps = _CAPS_CACHE.get(cap_key)
    if caps is None:
        caps = _derive_caps(np.asarray(counts))
        # provisional entry so the REST of a first batch skips the
        # counts fetch too (finish() refines it from actual counts)
        _CAPS_CACHE[cap_key] = caps

    def repack(caps2):
        """Rare cap-overflow path: RECOMPUTE the encode and repack.

        Recomputing (~one extra device pipeline) keeps the ctx from
        pinning the full-size coefficient/descriptor planes in device
        memory between stage and finish — the pipelined stream holds a
        whole lookahead batch of ctxs alive, and only the small output
        bundles may persist."""
        ck2, dsc2, cb2, sizes2, raw2, counts2, mf2 = encode()
        sub2, ai2, ab2 = pack(ck2, dsc2, cb2, caps2)
        blob2 = np.asarray(_bundle_outputs(
            sub2, ai2, ab2, sizes2, raw2, counts2, mf2
        ))
        return blob2, (
            tuple(sub2.shape), int(ai2.shape[0]), int(ab2.shape[0])
        )

    subrows, aidx, abytes = pack(coeff_chunks, desc, chunk_bytes, caps)
    bundle = _bundle_outputs(subrows, aidx, abytes, sizes, raw, counts, mf)
    return {
        "vol": vol, "block": block, "chunk": chunk, "cells": cells,
        "use_local": bool(use_local_rms), "glob_mulfac": glob_mulfac,
        "caps": caps, "repack": repack, "cap_key": cap_key,
        "bundle": bundle,
        "shapes": {
            "subrows": tuple(subrows.shape), "na": int(aidx.shape[0]),
            "nb": int(abytes.shape[0]), "n": int(sizes.shape[0]),
            "nc": int(counts.shape[0]),
        },
        "nbytes": int(bundle.size),
    }


def _compress_finish(ctx, blob_h):
    """Host finisher: split the fetched bundle, validate caps (repacking
    on the rare overflow), overlay raw-fallback payloads, assemble the
    container.  Returns (container_bytes, ratio)."""
    (subrows_h, aidx_h, abytes_h, sizes_h, raw_h, counts_h, mf_h) = (
        _split_blob(blob_h, ctx["shapes"])
    )
    vol, block, chunk, cells = (
        ctx["vol"], ctx["block"], ctx["chunk"], ctx["cells"]
    )
    bx, by, bz = block
    nz, ny, nx = vol.shape
    if not _caps_ok(counts_h, ctx["caps"]):
        # the stream's content jumped past the cached caps: repack with
        # exact caps (correctness never depends on the cache)
        blob2, (sub_shape, na2, nb2) = ctx["repack"](_derive_caps(counts_h))
        sh2 = dict(ctx["shapes"])
        sh2["subrows"] = sub_shape
        sh2["na"], sh2["nb"] = na2, nb2
        (subrows_h, aidx_h, abytes_h, sizes_h, raw_h, counts_h,
         mf_h) = _split_blob(blob2, sh2)
    _CAPS_CACHE[ctx["cap_key"]] = _derive_caps(counts_h)
    acount = int(counts_h[0])

    raw_bytes_h = None
    if raw_h.any():
        # raw blocks store the UNSCALED coefficients (CvxCompress.cpp:359);
        # the hot path keeps only scaled ones, so recompute (rare path)
        rblk = np.nonzero(raw_h)[0].astype(np.int32)
        ncpb = cells // chunk
        ridx = (rblk[:, None] * ncpb + np.arange(ncpb, dtype=np.int32)).ravel()
        uchunks = _raw_chunks(jnp.asarray(vol), block, chunk)
        raw_bytes_h = (
            np.asarray(_gather_rows(uchunks, jnp.asarray(ridx)))
            .reshape(rblk.size, cells)
            .view(np.uint8)
        )

    import time as _time

    global last_host_assembly_s
    t0 = _time.perf_counter()
    stream, _total = rle_device.assemble_payload_sparse(
        subrows_h, aidx_h, abytes_h, acount,
        sizes_h, raw_h, raw_bytes_h, cells, chunk,
    )

    gmf = ctx["glob_mulfac"]
    if isinstance(gmf, jax.Array):
        # device-computed mulfac: the f32 value rode the bundle (mf is a
        # broadcast of it in global mode; local mode never lands here)
        gmf = F32(mf_h[0])
    hdr = ctn.Header(nx, ny, nz, bx, by, bz, gmf, ctx["use_local"])
    data = ctn.pack_stream(
        hdr, sizes_h, raw_h, stream,
        mf_h if ctx["use_local"] else None,
    )
    last_host_assembly_s = _time.perf_counter() - t0
    ratio = (nx * ny * nz * 4) / data.size
    return data, ratio


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False,
             glob_mulfac=None):
    """Compress a (nz, ny, nx) float32 volume. Returns (container, ratio).

    `glob_mulfac` overrides the internally computed global quantization
    factor — used by the sharded/multi-host layer, where the global RMS is
    reduced across shards before any shard compresses.

    `vol` may be a DEVICE array (jax.Array): the volume then never leaves
    device memory — the production RTM shape, where snapshots are born on
    the device.
    The global RMS and mulfac are then computed ON DEVICE (_mulfac_dev)
    so the whole compress makes exactly ONE d2h fetch; the f32 math
    deviates from the host f64-accumulation contract by ~1 ulp of RMS
    (the same documented deviation as the snapshot stack).
    """
    vol = _prep_vol(vol)
    glob_mulfac = _prep_mulfac(vol, scale, use_local_rms, glob_mulfac)
    ctx = _compress_stage(vol, scale, block, use_local_rms, glob_mulfac)
    blob_h = np.asarray(ctx["bundle"])
    return _compress_finish(ctx, blob_h)


def compress_many(vols, scale, block=(32, 32, 32), use_local_rms=False,
                  glob_mulfacs=None):
    """Batched compress of K same-shape volumes. Returns [(container, ratio)].

    The K device pipelines dispatch back to back and EVERYTHING returns
    in one bundled d2h fetch (per-volume fetches each pay a host round
    trip).  Device-resident volumes' mulfacs are computed on device (no
    fetch at all).  Containers are byte-identical to
    per-volume compress() — same programs, same sticky caps.

    `glob_mulfacs` (optional, len K) overrides the per-volume global
    quantization factors (the sharded layer's contract).
    """
    vols = [_prep_vol(v) for v in vols]
    if not vols:
        return []
    if glob_mulfacs is None:
        glob_mulfacs = [None] * len(vols)
    # device volumes' mulfacs stay ON DEVICE (_mulfac_dev) — zero round
    # trips; host volumes keep the f64 reference contract
    mfs = [
        _prep_mulfac(v, scale, use_local_rms, m)
        for v, m in zip(vols, glob_mulfacs)
    ]
    ctxs = [
        _compress_stage(v, scale, block, use_local_rms, m)
        for v, m in zip(vols, mfs)
    ]
    # ONE fetch for the whole batch
    if len(ctxs) == 1:
        blob = np.asarray(ctxs[0]["bundle"])
    else:
        blob = np.asarray(jnp.concatenate([c["bundle"] for c in ctxs]))
    out = []
    off = 0
    for c in ctxs:
        nb = c["nbytes"]
        out.append(_compress_finish(c, blob[off:off + nb]))
        off += nb
    return out


@functools.partial(jax.jit, static_argnames=("vol_shape", "block", "chunk"))
def _decompress_sparse_blockmajor(payload_rows, invmap, vol_shape, block,
                                  chunk):
    """Chunk-sparse coefficients -> volume via the block-major expand.

    The test reference for _decompress_sparse: row-gather to a dense
    block-major batch, inverse transform, then the 6D un-layout transpose.
    """
    bx, by, bz = block
    padded = jnp.concatenate(
        [payload_rows, jnp.zeros((1, chunk), jnp.float32)], axis=0
    )
    dense = jnp.take(padded, invmap, axis=0)  # (nchunks, chunk) row gather
    cb = dense.reshape(-1, bz, by, bx)
    out = wavelet.inverse_3d(cb)
    return blk.from_blocks(out, vol_shape, block)


def _sparse_to_plane(payload_rows, invmap, vol_shape, block, chunk):
    """Chunk-sparse coefficients -> volume-order COEFFICIENT plane.

    Expands straight into VOLUME order (reference: CvxCompress.cpp:528-568
    decode -> inverse -> scatter per block, with no block-major relayout):
    the (cheap, /bx-sized) sub-row INDEX array is transposed instead of
    the data, then one row gather.  The plane carries the decode plane's
    phantom all-zero x-block columns (wavelet.padded_nbx); the pad rides
    the gather as an index constant pointing at the shared zero row, not
    a data copy.
    """
    nz, ny, nx = vol_shape
    bx, by, bz = block
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    w = min(bx, chunk)
    rpc = chunk // w
    ppb = bx // w
    acap = payload_rows.shape[0]
    nbx2 = wavelet.padded_nbx(nbx, bx)

    padded = jnp.concatenate(
        [payload_rows, jnp.zeros((1, chunk), jnp.float32)], axis=0
    )
    sub = padded.reshape((acap + 1) * rpc, w)
    g = invmap[:, None] * rpc + jnp.arange(rpc, dtype=jnp.int32)[None, :]
    g = g.reshape(nbz, nby, nbx, bz, by, ppb)
    if nbx2 > nbx:
        g = jnp.pad(
            g, ((0, 0), (0, 0), (0, nbx2 - nbx), (0, 0), (0, 0), (0, 0)),
            constant_values=acap * rpc,  # a sub-row of the zero pad row
        )
    g = g.transpose(0, 3, 1, 4, 2, 5)
    rows = jnp.take(sub, g.reshape(-1), axis=0)
    return rows.reshape(nbz * bz * nby * by, nbx2 * bx)


@functools.partial(jax.jit, static_argnames=("vol_shape", "block", "chunk"))
def _decompress_sparse(payload_rows, invmap, vol_shape, block, chunk):
    """Chunk-sparse rows -> volume, through the SAME inverse as the device
    decode engine (_inverse_from_plane on the same plane layout), so
    snapshot reconstruction, host-engine and device-engine decompress are
    bit-identical."""
    plane = _sparse_to_plane(payload_rows, invmap, vol_shape, block, chunk)
    return _inverse_from_plane(plane, vol_shape, block)


def _decode_payloads_host(data, hdr, blkoffs, blkmulfac, payload_base):
    """Entropy-decode all block payloads on host -> (nnn, cells) f32 coeffs.

    Uses the native C++ decoder when available, else the NumPy oracle.
    """
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    nnn = hdr.grid[3]
    bx, by, bz = hdr.bx, hdr.by, hdr.bz
    cells = bx * by * bz

    try:
        from . import rle_host

        native = rle_host.available()
    except Exception:
        native = False

    if native:
        return rle_host.decode_payloads(
            raw[payload_base:], blkoffs,
            blkmulfac if hdr.use_local_rms else None,
            hdr.glob_mulfac, cells,
        )

    from ..oracle import rle as orle

    coeffs = np.empty((nnn, cells), dtype=F32)
    for ib in range(nnn):
        off = int(blkoffs[ib])
        is_raw = off < 0
        off &= 0x7FFFFFFFFFFFFFFF
        start = payload_base + off
        if is_raw:
            rb = raw[start : start + 4 * cells]
            if rb.size != 4 * cells:
                raise ValueError("corrupt container: raw block truncated")
            coeffs[ib] = rb.copy().view(F32)
        else:
            mulfac = blkmulfac[ib] if hdr.use_local_rms else hdr.glob_mulfac
            try:
                coeffs[ib], _ = orle.decode(mulfac, raw[start:], cells)
            except IndexError:
                raise ValueError(
                    "corrupt container: block stream truncated"
                ) from None
    return coeffs


def sparse_chunks(coeffs, cells, chunk):
    """Host: dense (nnn, cells) coeffs -> (payload_rows, invmap, acap).

    payload_rows (acap, chunk) f32 holds the nonzero chunks in order;
    invmap (nchunks,) int32 maps every chunk to its payload row (acap =
    the shared zero row for all-zero chunks).  h2d traffic ∝ nonzero data.
    """
    nchunks = coeffs.size // chunk
    rows = coeffs.reshape(nchunks, chunk)
    try:
        from . import rle_host

        flags = (
            rle_host.chunk_flags(rows, chunk)
            if rle_host.available()
            else rows.any(axis=1)
        )
    except Exception:
        flags = rows.any(axis=1)
    idx = np.nonzero(flags)[0]
    acap = rle_device.bucket(idx.size, lo=1)
    payload = np.zeros((acap, chunk), dtype=F32)
    payload[: idx.size] = rows[idx]
    invmap = np.full(nchunks, acap, dtype=np.int32)
    invmap[idx] = np.arange(idx.size, dtype=np.int32)
    return payload, invmap, acap


def _inverse_from_plane(plane, vol_shape, block):
    """Inverse wavelet of a volume-order coefficient plane (in-trace):
    x on full plane rows, then y and z in volume order."""
    plane = wavelet.apply_x_inverse_rows(plane, block[0])
    return wavelet.inverse_3d_volume(plane, vol_shape, block)


@functools.partial(jax.jit, static_argnames=("vol_shape", "block"))
def _inverse_volume_plane(plane, vol_shape, block):
    """Padded volume-order coefficient plane -> volume (x, y, z inverse)."""
    return _inverse_from_plane(plane, vol_shape, block)


@functools.partial(jax.jit, static_argnames=("vol_shape", "block", "nseg_s"))
def _decode_and_inverse(segs, sub_block, sub_reset, scalefac, vol_shape,
                        block, nseg_s):
    """Entropy parse + inverse wavelet in ONE program (no boundary
    materialization of the coefficient plane)."""
    from . import entropy_decode as ed

    plane = ed.decode_to_volume.__wrapped__(
        segs, sub_block, sub_reset, scalefac, vol_shape, block, nseg_s,
    )
    return _inverse_from_plane(plane, vol_shape, block)


@functools.partial(
    jax.jit, static_argnames=("nseg", "segw", "nsub", "nsf")
)
def _unbundle_plan(blob, nseg, segw, nsub, nsf):
    """ONE h2d buffer -> (segs, sub_block, sub_reset, scalefac).

    The four plan arrays upload as one concatenated u8 blob: one h2d
    transfer instead of four."""
    o0 = nseg * segw
    o1 = o0 + 4 * nsub
    o2 = o1 + nsub
    segs = blob[:o0].reshape(nseg, segw)
    sub_block = jax.lax.bitcast_convert_type(
        blob[o0:o1].reshape(nsub, 4), jnp.int32
    )
    sub_reset = blob[o1:o2] != 0
    scalefac = jax.lax.bitcast_convert_type(
        blob[o2 : o2 + 4 * nsf].reshape(nsf, 4), jnp.float32
    )
    return segs, sub_block, sub_reset, scalefac


def _upload_plan(p):
    segs = np.ascontiguousarray(p["segs"], dtype=np.uint8)
    sb = np.ascontiguousarray(p["sub_block"], dtype=np.int32)
    sr = np.ascontiguousarray(p["sub_reset"]).astype(np.uint8)
    sf = np.ascontiguousarray(p["scalefac"], dtype=np.float32)
    blob = np.concatenate([
        segs.reshape(-1), sb.view(np.uint8), sr, sf.view(np.uint8)
    ])
    return _unbundle_plan(
        jnp.asarray(blob), segs.shape[0], segs.shape[1], sb.shape[0],
        sf.shape[0],
    )


def decompress_device(data, to_host=True):
    """Fully device-side decompress: entropy parse + inverse on the device.

    Device-complete counterpart of the reference's in-engine decompress
    (CvxCompress.cpp:528-568): the grammar parse (ops.entropy_decode), the
    scatter-expand, and the inverse wavelet all run on device; the host
    only parses the container and memcpys the payload into segment rows
    (∝ compressed size).  Returns None when the container's spans are
    degenerate (host path decides then).  `to_host=False` returns the
    volume as a DEVICE array (no d2h — the RTM backward-pass shape).
    """
    from . import entropy_decode as ed

    # staging reuse is safe here: the previous call's segs were uploaded
    # before this call can run (sequential per-thread decompress)
    p = ed.plan(data, reuse_staging=True)
    if p is None:
        return None
    hdr = p["hdr"]
    vol_shape = (hdr.nz, hdr.ny, hdr.nx)
    block = (hdr.bx, hdr.by, hdr.bz)
    segs, sub_block, sub_reset, scalefac = _upload_plan(p)
    if p["raw_ids"].size:
        # rare: keep the staged path so the raw overlay can interpose
        plane = ed.decode_to_volume(
            segs, sub_block, sub_reset, scalefac,
            vol_shape, block, p["segs"].shape[0],
        )
        plane = ed.overlay_raw(
            plane, jnp.asarray(p["raw_rows"]), jnp.asarray(p["raw_ids"]),
            vol_shape, block,
        )
        out = _inverse_volume_plane(plane, vol_shape, block)
        return np.asarray(out) if to_host else out
    out = _decode_and_inverse(
        segs, sub_block, sub_reset, scalefac,
        vol_shape, block, p["segs"].shape[0],
    )
    return np.asarray(out) if to_host else out


# Sticky per-(geometry, mode) segment-count bucket for the batched
# decode: a stream of similar containers settles on one row stride (one
# compile), and the cap only grows (few compiles on drift).
_DEC_CAPS = {}


def _plan_row_stride(nseg_cap, local):
    from . import entropy_decode as ed

    nsub = nseg_cap * ed.SPS
    return nseg_cap * ed.SEG + 5 * nsub + 4 * (nsub if local else 1)


def _plan_rows(plans, nseg_cap, nnn, local):
    """Serialize K decode plans into ONE (K, stride) u8 blob.

    A fixed row stride makes the whole batch ONE h2d upload (each
    device_put through a transport pays its own latency); rows slice
    apart on device.  Padding rows are inert subsegments: reset=True,
    virtual block nnn (their scatter targets land at/past the discard
    slot), zero segment bytes.
    """
    from . import entropy_decode as ed

    k = len(plans)
    nsub = nseg_cap * ed.SPS
    o0 = nseg_cap * ed.SEG
    o1 = o0 + 4 * nsub
    o2 = o1 + nsub
    blob = np.empty((k, _plan_row_stride(nseg_cap, local)), np.uint8)
    for i, p in enumerate(plans):
        nseg = p["segs"].shape[0]
        ns = nseg * ed.SPS
        row = blob[i]
        sv = row[:o0].reshape(nseg_cap, ed.SEG)
        sv[:nseg] = p["segs"]
        sv[nseg:] = 0
        sb = row[o0:o1].view(np.int32)
        sb[:ns] = p["sub_block"]
        sb[ns:] = nnn
        sr = row[o1:o2]
        sr[:ns] = p["sub_reset"]
        sr[ns:] = 1
        sf = row[o2:].view(np.float32)
        if local:
            sf[:ns] = p["scalefac"]
            sf[ns:] = 1.0
        else:
            sf[0] = p["scalefac"][0]
    return blob


def _unbundle_row(row, nseg_cap, local):
    """In-trace split of one _plan_rows row (shared by the decode jits)."""
    from . import entropy_decode as ed

    nsub = nseg_cap * ed.SPS
    o0 = nseg_cap * ed.SEG
    o1 = o0 + 4 * nsub
    o2 = o1 + nsub
    segs = row[:o0].reshape(nseg_cap, ed.SEG)
    sub_block = jax.lax.bitcast_convert_type(
        row[o0:o1].reshape(nsub, 4), jnp.int32
    )
    sub_reset = row[o1:o2] != 0
    nsf = nsub if local else 1
    scalefac = jax.lax.bitcast_convert_type(
        row[o2:o2 + 4 * nsf].reshape(nsf, 4), jnp.float32
    )
    return segs, sub_block, sub_reset, scalefac


@functools.partial(
    jax.jit, static_argnames=("vol_shape", "block", "nseg_cap", "local")
)
def _decode_and_inverse_row(row, vol_shape, block, nseg_cap, local):
    """Plan-row unbundle + entropy parse + inverse in ONE program."""
    from . import entropy_decode as ed

    segs, sub_block, sub_reset, scalefac = _unbundle_row(
        row, nseg_cap, local
    )
    plane = ed.decode_to_volume.__wrapped__(
        segs, sub_block, sub_reset, scalefac, vol_shape, block, nseg_cap,
    )
    return _inverse_from_plane(plane, vol_shape, block)


@functools.partial(
    jax.jit, static_argnames=("vol_shape", "block", "nseg_cap", "local")
)
def _decode_plane_row(row, vol_shape, block, nseg_cap, local):
    """Plan-row decode to the coefficient plane (raw-overlay staging)."""
    from . import entropy_decode as ed

    segs, sub_block, sub_reset, scalefac = _unbundle_row(
        row, nseg_cap, local
    )
    return ed.decode_to_volume.__wrapped__(
        segs, sub_block, sub_reset, scalefac, vol_shape, block, nseg_cap,
    )


def decompress_many(datas, to_host=True):
    """Batched device decompress of K same-geometry containers.

    ONE h2d upload carries every plan (each transfer pays its own
    latency), then K per-volume decode+inverse programs dispatch back to
    back.

    The decode is bit-identical to per-volume decompress_device (same
    programs, padded with inert subsegments).

    Returns a list of K volumes (host np arrays, or device arrays when
    `to_host=False` — the RTM backward-pass shape), or None when any
    container is degenerate or geometries differ (caller falls back to
    per-volume decompress).
    """
    k = len(datas)
    if k == 0:
        return []
    if k == 1:
        out = decompress_device(datas[0], to_host=to_host)
        return None if out is None else [out]
    vols = _decompress_many_stage(datas)
    if vols is None:
        return None
    if to_host:
        vh = np.asarray(vols)  # ONE d2h for the whole batch
        return [vh[i] for i in range(k)]
    return [vols[i] for i in range(k)]


def _decompress_many_prepare(datas):
    """Host half of the batched decode: plans + the serialized plan
    blob.  No device work — the pipelined stream runs this on the main
    thread while its transfer worker owns the transport.  Returns None
    for degenerate/mixed-geometry inputs."""
    from . import entropy_decode as ed

    plans = [ed.plan(d, reuse_staging=False) for d in datas]
    if any(p is None for p in plans):
        return None
    h0 = plans[0]["hdr"]
    geom = (h0.nz, h0.ny, h0.nx, h0.bx, h0.by, h0.bz)
    for p in plans[1:]:
        h = p["hdr"]
        if (h.nz, h.ny, h.nx, h.bx, h.by, h.bz) != geom:
            return None
    local = bool(h0.use_local_rms)
    nnn = h0.grid[3]

    need = max(p["segs"].shape[0] for p in plans)
    cap_key = (geom, local)
    cap = _DEC_CAPS.get(cap_key, 0)
    if need > cap:
        # 64-seg granularity, not power-of-2: the blob upload pays real
        # transfer time per padded byte (pow-2 caps averaged ~1.5x the
        # live segs = ~25% of the whole upload), and the sticky cap only
        # grows, so compile count stays bounded
        cap = -(-need // 64) * 64  # need >= 1, so cap >= 64
        _DEC_CAPS[cap_key] = cap

    blob_h = _plan_rows(plans, cap, nnn, local)
    return plans, blob_h, (geom, cap, local)


def _decompress_many_dispatch(prep):
    """Transfer + dispatch half: ONE h2d of the plan blob, then K
    per-volume decode+inverse programs.  Returns the (K, ...) DEVICE
    array (no sync)."""
    from . import entropy_decode as ed

    plans, blob_h, (geom, cap, local) = prep
    vol_shape, block = geom[:3], geom[3:]
    blob = jnp.asarray(blob_h)  # ONE h2d
    outs = []
    for i, p in enumerate(plans):
        row = blob[i]
        if p["raw_ids"].size:
            plane = _decode_plane_row(row, vol_shape, block, cap, local)
            plane = ed.overlay_raw(
                plane, jnp.asarray(p["raw_rows"]),
                jnp.asarray(p["raw_ids"]), vol_shape, block,
            )
            outs.append(_inverse_volume_plane(plane, vol_shape, block))
        else:
            outs.append(_decode_and_inverse_row(
                row, vol_shape, block, cap, local
            ))
    return jnp.stack(outs)


def _decompress_many_stage(datas):
    """Dispatch the batched decode; returns the (K, nz, ny, nx) DEVICE
    array (no sync), or None for degenerate/mixed-geometry inputs."""
    prep = _decompress_many_prepare(datas)
    return None if prep is None else _decompress_many_dispatch(prep)


def decompress(data, engine="auto"):
    """Decompress a container to a (nz, ny, nx) float32 volume.

    engine:
      "auto"   — the engine measured faster on this platform (auto_engine)
      "device" — the device entropy decoder (ops.entropy_decode)
      "host"   — host entropy decode (native C++ / oracle)

    The container is structurally validated first — the decoders bound
    every read by the payload extent, and validate() rejects structural
    damage before any work is dispatched.
    """
    from ..utils import io as _io

    _io.validate(data)
    use = auto_engine() if engine == "auto" else engine
    if use == "device":
        out = decompress_device(data)
        if out is not None:
            return out
        if engine == "device":
            raise ValueError("container not decodable on device")
        # "auto": degenerate spans (decompress_device) decode on host
    elif use != "host":
        raise ValueError(f"unknown engine {engine!r}")
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    block = (hdr.bx, hdr.by, hdr.bz)
    cells = hdr.bx * hdr.by * hdr.bz
    chunk = rle_device.chunk_cells(cells)
    coeffs = _decode_payloads_host(data, hdr, blkoffs, blkmulfac, payload_base)
    payload, invmap, _ = sparse_chunks(coeffs, cells, chunk)
    vol = _decompress_sparse(
        jnp.asarray(payload), jnp.asarray(invmap),
        (hdr.nz, hdr.ny, hdr.nx), block, chunk,
    )
    return np.asarray(vol)
