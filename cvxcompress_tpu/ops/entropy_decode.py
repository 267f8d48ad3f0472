"""Device entropy decoder: parallel parse of the RLE/escape grammar.

The reference decodes sequentially per block (Run_Length_Decode_Slow,
/root/reference/Run_Length_Encode_Slow.cpp:388-527, one cursor chasing
variable-length tokens).  A sequential byte cursor cannot run data-parallel,
so this module re-states the parse as data-parallel passes — the device
counterpart of the reference's decoder and the piece that makes
decompression device-complete (SURVEY.md §7 hard part #1):

  1. Token lengths are a pure function of the leading byte, so the token
     boundary structure of any 32-byte SUBSEGMENT is summarized by a tiny
     transfer map: for each of 25 possible entry offsets (a token is at
     most 25 bytes, so a token crossing a boundary enters at offset < 25),
     where does the token chain exit, and how many values does it emit.
     A 32-step unrolled bit-DP computes all 25 hypotheses of every
     subsegment AT ONCE (M[p] = 25-bit mask: "p is a token start under
     entry e").
  2. Transfer maps compose associatively (index-table composition +
     saturated affine value counts), so the true entry offset and output
     cursor of every subsegment come from a sequential within-segment
     compose plus one segmented `associative_scan` over segments.
     Composition is 25 broadcast-compare selects (elementwise).
  3. Decoding is then embarrassingly parallel per byte: each byte knows
     whether it starts a token (its entry bit of the DP), what it emits,
     and where (an in-subsegment prefix sum + the scanned cursor);
     group-of-8 tokens are unrolled into per-carrier-byte emissions via
     static shifts.  One scatter places the dequantized values into the
     padded volume in VOLUME ORDER (the block-major -> volume index
     transform is free arithmetic on scatter indices), feeding the
     relayout-free inverse wavelet directly.

Block payloads are packed back-to-back at 32-byte (subsegment) alignment —
parse state resets at block starts, marked per subsegment — so staging is
~compressed-size, not blocks*512.  Parse chains that run past a block's
true payload into alignment padding are harmless by construction: the
output cursor saturates at `cells` exactly when the true payload ends, so
every post-end emission fails the `pos < cells` mask.

Everything is fixed-shape, branch-free XLA; cost scales with payload size
(compressed bytes), not volume size.  Raw-fallback blocks are rare and are
overlaid by `overlay_raw`.  Two scatter layouts share the parse stages:
`decode_to_volume` (single-chip: straight into the padded volume) and
`decode_to_blocks` (multi-chip: a shard-local block batch for the
shard_map path in parallel/compress.py).

Byte-exactness: emitted values are float(int32) * (1.0f/mulfac) with the
same single f32 rounding as the reference decoder; tests assert the
scattered coefficient volume is bit-identical to the host decoders'.
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
from .. import container as ctn

SEG = 512  # segment bytes
W = 32  # subsegment bytes (the DP unit; > max token length 25)
SPS = SEG // W
E = 25  # entry offsets: max token length is 25 bytes (VLESC3_8x)
LOOK = 25  # lookahead bytes visible past a row for cross-boundary tokens

_LENGTHS = ((127, 2), (125, 4), (-125, 3), (-127, 4), (-126, 17), (126, 25),
            (-128, 5))


def _gather_runs_numpy(src, soff, dst, doff, nbytes):
    """Vectorized numpy ragged copy (repeat+cumsum index construction,
    ~3 passes over the copied bytes) — the no-native fallback."""
    n = nbytes.astype(np.int64)
    tot = int(n.sum())
    if tot == 0:
        return
    # src index stream: runs [soff[i], soff[i]+n[i]) back to back
    step = np.ones(tot, dtype=np.int64)
    starts = np.cumsum(n)[:-1]
    step[0] = soff[0]
    step[starts] = soff[1:] - (soff[:-1] + n[:-1] - 1)
    sidx = np.cumsum(step)
    dstep = np.ones(tot, dtype=np.int64)
    dstep[0] = doff[0]
    dstep[starts] = doff[1:] - (doff[:-1] + n[:-1] - 1)
    didx = np.cumsum(dstep)
    dst[didx] = src[sidx]


def _ragged_copy_fill_host(src, soff, dst, doff, nbytes, align):
    """dst[doff[i]:+nbytes[i]] = src[soff[i]:+nbytes[i]], then zero each
    span's tail up to the next `align` boundary — no Python loop: the
    native OpenMP memcpy fan when available, else vectorized numpy."""
    if soff.size == 0:
        return
    try:
        from . import rle_host

        if rle_host.available():
            rle_host.ragged_copy_fill(src, soff, dst, doff, nbytes, align)
            return
    except Exception:
        pass
    _gather_runs_numpy(src, soff, dst, doff, nbytes)
    # zero the alignment gaps (dst spans [doff+n, doff+align_up(n)))
    gaps = (-nbytes) & (align - 1)
    gi = np.nonzero(gaps)[0]
    if gi.size:
        zsrc = np.zeros(align, dtype=np.uint8)
        _gather_runs_numpy(
            zsrc, np.zeros(gi.size, np.int64), dst,
            (doff[gi] + nbytes[gi]).astype(np.int64),
            gaps[gi].astype(np.int64),
        )


_plan_tls = threading.local()


def _plan_staging(nseg, reuse):
    """(nseg, SEG) u8 staging rows; `reuse` recycles a per-thread buffer
    (fresh pages cost ~page-fault-bound writes; a warm buffer is ~5x
    faster to fill).  Only safe when the caller has finished with the
    PREVIOUS plan's segs (uploaded / copied) — the codec's sequential
    decompress and the per-thread pipeline workers both qualify."""
    if not reuse:
        return np.empty((nseg, SEG), np.uint8)
    buf = getattr(_plan_tls, "buf", None)
    if buf is None or buf.shape[0] < nseg:
        buf = np.empty((max(nseg, 64), SEG), np.uint8)
        _plan_tls.buf = buf
    return buf[:nseg]


def plan(data, reuse_staging=False):
    """Host-side planning: container -> segment arrays for the device parse.

    Returns None when the container's spans are degenerate, else a dict of
    numpy arrays + static config.  Cost is one ragged memcpy of the payload
    into the aligned stream plus O(nsub) span arithmetic (all ∝ compressed
    size, NO per-block Python loop), mirroring the compress side's host
    assembly.  `reuse_staging` recycles a per-thread segs buffer (see
    _plan_staging) — pass True only when the previous call's segs are no
    longer referenced (the codec's decompress paths qualify).
    """
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    nnn = hdr.grid[3]
    cells = hdr.bx * hdr.by * hdr.bz
    raw = np.frombuffer(memoryview(data), dtype=np.uint8)
    payload = raw[payload_base:]
    avail = payload.size

    offs64 = np.asarray(blkoffs, dtype=np.int64)
    is_raw = offs64 < 0
    offs = offs64 & ~ctn.RAW_FLAG
    # per-block payload spans: a block ends where the next-larger offset
    # starts (valid for any payload order, incl. the reference's
    # thread-completion order, CvxCompress.cpp:370-374)
    order = np.argsort(offs, kind="stable")
    ends = np.empty(nnn, dtype=np.int64)
    ends[order[:-1]] = offs[order[1:]]
    ends[order[-1]] = avail
    sizes = np.where(is_raw, 4 * cells, ends - offs)
    if (sizes <= 0).any() or (offs + sizes > avail).any():
        return None  # degenerate/corrupt spans: let the host path decide

    rle = ~is_raw
    asz = np.where(rle, -(-sizes // W) * W, 0)  # W-aligned stream extents
    base = np.cumsum(asz) - asz  # per-block start in the packed stream
    total = int(asz.sum())
    nsub = max(SPS, -(-total // W))
    nseg = -(-nsub // SPS)
    nsub = nseg * SPS

    segs = _plan_staging(nseg, reuse_staging)
    flat = segs.reshape(-1)
    rle_ids = np.nonzero(rle)[0]
    # copy block payloads + zero each span's W-alignment tail in one pass
    _ragged_copy_fill_host(
        payload, offs[rle_ids], flat, base[rle_ids], sizes[rle_ids], W
    )
    flat[total:] = 0  # trailing padding subsegments (inert, deterministic)
    # sub_block: owning block per subsegment (virtual block nnn for the
    # tail padding — its scatter targets land at/past the discard slot)
    sub_block = np.full(nsub, nnn, dtype=np.int32)
    # raw blocks occupy zero stream bytes, so RLE blocks' subsegment runs
    # are contiguous in ascending block order: one repeat covers them all
    sub_block[: total // W] = np.repeat(
        rle_ids.astype(np.int32), asz[rle_ids] // W
    )
    sub_reset = np.zeros(nsub, dtype=bool)
    sub_reset[total // W :] = True  # padding subsegments restart (inert)
    sub_reset[base[rle_ids] // W] = True

    if hdr.use_local_rms:
        mf = np.concatenate(
            [np.asarray(blkmulfac, np.float32), [np.float32(1.0)]]
        )
        scalefac = (np.float32(1.0) / mf)[sub_block]
    else:
        # constant scalefac: a 1-element array the decode jits broadcast
        # on device (no O(nsub) host build or upload)
        scalefac = np.full(
            1, np.float32(1.0) / np.float32(hdr.glob_mulfac), np.float32
        )

    raw_ids = np.nonzero(is_raw)[0].astype(np.int32)
    raw_rows = (
        np.stack(
            [
                payload[int(offs[b]) : int(offs[b]) + 4 * cells]
                .copy()
                .view(np.float32)
                for b in raw_ids
            ]
        )
        if raw_ids.size
        else None
    )
    return {
        "segs": segs,
        "sub_block": sub_block,
        "sub_reset": sub_reset,
        "scalefac": scalefac,
        "hdr": hdr,
        "cells": cells,
        "raw_ids": raw_ids,
        "raw_rows": raw_rows,
    }


def _i8(b):
    """u8 plane -> signed value in [-128, 127]."""
    return b - 256 * (b >= 128)


def _parse_stages(segs, sub_reset, cells):
    """Shared parse: byte planes, subsegment bit-DP, transfer maps, and
    the cross-subsegment entry/cursor recurrence.  Returns
    (M, e32, c32, vals_s, sv, Bx) for the emit stage."""
    nseg = segs.shape[0]
    nsub = nseg * SPS
    CAP = jnp.int32(cells)

    B = segs.astype(jnp.int32)  # (nseg, SEG) byte planes
    # right lookahead: the packed stream is contiguous across rows; reads
    # that cross a block end fetch garbage that is masked by cursor
    # saturation, so no continuation masking is needed
    nxt_head = jnp.concatenate(
        [B[1:, :LOOK], jnp.zeros((1, LOOK), jnp.int32)], axis=0
    )
    Bx = jnp.concatenate([B, nxt_head], axis=1)  # (nseg, SEG+LOOK)

    def plane(k):
        return Bx[:, k : k + SEG]

    b0 = B
    sv = _i8(b0)
    ln = jnp.ones_like(b0)
    for code, tl in _LENGTHS:
        ln = jnp.where(sv == code, tl, ln)
    vals = jnp.ones_like(b0)
    vals = jnp.where(sv == 127, plane(1), vals)  # RLESC1: run in [1,255]
    run3 = plane(1) | (plane(2) << 8) | (plane(3) << 16)
    vals = jnp.where(sv == 125, jnp.minimum(run3, CAP), vals)  # RLESC3
    vals = jnp.where((sv == -126) | (sv == 126), 8, vals)  # group-of-8

    # ---- 1. subsegment bit-DP: 25 entry hypotheses at once --------------
    ln_s = ln.reshape(nsub, W)
    cols = []
    lcols = [ln_s[:, p] for p in range(W)]
    for p in range(W):
        col = jnp.full((nsub,), 1 << p if p < E else 0, dtype=jnp.int32)
        for tl in (1, 2, 3, 4, 5, 17, 25):
            if p - tl >= 0:
                col = col | jnp.where(
                    lcols[p - tl] == tl, cols[p - tl], 0
                )
        cols.append(col)
    M = jnp.stack(cols, axis=1)  # (nsub, W) entry bitmasks

    nxt_start = jnp.arange(W, dtype=jnp.int32)[None, :] + ln_s
    cross = nxt_start >= W
    exit_off = nxt_start - W  # in [0, E) where cross
    vals_s = vals.reshape(nsub, W)
    # per-entry masked reductions; a one-shot (nsub, W, E) bits-tensor
    # formulation measured no better end-to-end (XLA fuses this loop)
    T = jnp.zeros((nsub, E), jnp.int32)
    NV = jnp.zeros((nsub, E), jnp.int32)
    for e in range(E):
        bits = (M >> e) & 1
        T = T.at[:, e].set(jnp.sum(bits * cross * exit_off, axis=1))
        NV = NV.at[:, e].set(
            jnp.minimum(jnp.sum(bits * vals_s, axis=1), CAP)
        )

    # ---- 2. cross-subsegment entry/cursor recurrence --------------------
    # Segmented scan of index-table maps.  State (entry t, count v) is
    # PACKED as p = v*32 + t (t < 32, v*32 < 2^31 for any legal block
    # size) and table lookups are one vectorized compare-mask-reduce over
    # a (..., E, E) bitmask.  Both levels run as LOG-DEPTH Sklansky scans:
    # 4 batched rounds over the SPS submaps and ~log2(nseg) over segments.

    eye = jnp.arange(E, dtype=jnp.int32)

    def lookup(ptab, idx):
        """out[..., e] = ptab[..., idx[..., e]] via mask-reduce."""
        m = idx[..., :, None] == eye
        return jnp.sum(jnp.where(m, ptab[..., None, :], 0), axis=-1)

    def combine(p1, r1, p2, r2):
        """Apply map p1 then p2 (reset in p2's span discards p1)."""
        g = lookup(p2, p1 & 31)
        p = jnp.minimum((p1 >> 5) + (g >> 5), CAP) * 32 + (g & 31)
        return jnp.where(r2[..., None], p2, p), r1 | r2

    def sklansky(p, r, axis_len):
        """Inclusive reset-aware map scan along the second-to-last axis
        (length a power of two) in log2 batched rounds: each round
        composes the left half-block's trailing prefix into every right
        half-block slot."""
        lead = p.shape[:-2]
        s = 1
        while s < axis_len:
            g2 = 2 * s
            pv = p.reshape(*lead, axis_len // g2, g2, E)
            rv = r.reshape(*lead, axis_len // g2, g2)
            cp, cr = combine(
                pv[..., s - 1 : s, :], rv[..., s - 1 : s],
                pv[..., s:, :], rv[..., s:],
            )
            p = jnp.concatenate([pv[..., :s, :], cp], axis=-2)
            p = p.reshape(*lead, axis_len, E)
            r = jnp.concatenate([rv[..., :s], cr], axis=-1)
            r = r.reshape(*lead, axis_len)
            s = g2
        return p, r

    P3 = (NV * 32 + T).reshape(nseg, SPS, E)  # packed submaps
    R2 = sub_reset.reshape(nseg, SPS)
    identP = jnp.broadcast_to(eye[None, :], (nseg, E))  # v=0, t=e
    # level 1: scan the SPS submaps of each segment.  A block-start
    # reset collapses the incoming state to entry 0 BEFORE its submap
    # applies, so bake it into the element as the constant f_k(0) map;
    # the flag-aware combine then discards the left prefix exactly like
    # the sequential compose did.
    Pb = jnp.where(R2[:, :, None], P3[:, :, 0:1], P3)
    inc1, _rin1 = sklansky(Pb, R2, SPS)
    excl = jnp.concatenate([identP[:, None, :], inc1[:, :-1, :]], axis=1)
    pref = jnp.where(R2[:, :, None], 0, excl)  # state map BEFORE sub k
    curP = inc1[:, -1, :]  # per-segment since-last-reset map

    # level 2: Sklansky over SEGMENT maps (padded to a power of two; the
    # identity tail never reaches rows < nseg)
    r_seg = R2.any(axis=1)
    n2 = 1 << max(0, (int(nseg) - 1).bit_length())
    padP = jnp.concatenate(
        [curP, jnp.broadcast_to(eye[None, :], (n2 - nseg, E))], axis=0
    )
    padR = jnp.concatenate(
        [r_seg, jnp.zeros((n2 - nseg,), r_seg.dtype)], axis=0
    )
    inc2, _ = sklansky(padP, padR, n2)
    pi = inc2[:nseg]
    prev_p = jnp.concatenate([identP[:1], pi[:-1]], axis=0)
    eseg = prev_p[:, 0] & 31  # entry state at each segment's first byte
    cseg = prev_p[:, 0] >> 5

    # level 3: push each segment's entry through its submap prefixes in
    # ONE batched lane-gather; subs past an internal reset use the
    # (entry-independent) post-reset state
    post = jnp.cumsum(R2.astype(jnp.int32), axis=1) > 0
    sel = jnp.take_along_axis(
        pref, eseg[:, None, None], axis=2
    )[:, :, 0]  # (nseg, SPS)
    e32 = (sel & 31).reshape(nsub)
    pv = sel >> 5
    c32 = jnp.where(
        post, pv, jnp.minimum(cseg[:, None] + pv, CAP)
    ).reshape(nsub)

    return M, e32, c32, vals_s, sv, Bx


@functools.partial(jax.jit, static_argnames=("vol_shape", "block", "nseg_s"))
def decode_to_volume(segs, sub_block, sub_reset, scalefac, vol_shape, block,
                     nseg_s):
    """Device parse: segment rows -> padded VOLUME-ORDER coefficient plane.

    Returns (nzp*nyp, nxp2) float32 — dequantized wavelet coefficients in
    volume order (x-padded to 128-lane alignment), ready for the
    relayout-free inverse (apply_x_inverse_rows + inverse_3d_volume).
    """
    del nseg_s  # shapes are already static via segs
    bx, by, bz = block
    cells = bx * by * bz
    M, e32, c32, vals_s, sv, Bx = _parse_stages(segs, sub_reset, cells)
    return _emit_and_scatter(
        M, e32, c32, vals_s, sv, Bx, scalefac, sub_block, vol_shape, block,
    )



def _emit_values(M, e32, c32, vals_s, sv, Bx, scalefac, cells):
    """Per-byte decode to (emit, val, pos) planes over (nseg, SEG): which
    bytes carry an output value, the dequantized value, and its
    block-major cell position (shared by both scatter layouts)."""
    CAP = jnp.int32(cells)
    nseg = Bx.shape[0]
    b0 = Bx[:, :SEG]

    def plane(k):
        return Bx[:, k : k + SEG]

    # ---- per-byte decode --------------------------------------------
    is_start = ((M >> e32[:, None]) & 1).astype(jnp.int32)  # (nsub, W)
    tv = vals_s * is_start
    p_excl = jnp.cumsum(tv, axis=1) - tv
    out_base = jnp.minimum(c32[:, None] + p_excl, CAP)  # (nsub, W)

    is_start = is_start.reshape(nseg, SEG)
    out_base = out_base.reshape(nseg, SEG)
    if scalefac.shape[0] == 1:  # global-RMS: one scalar for the volume
        sf = jnp.broadcast_to(scalefac.reshape(1, 1), (nseg, SEG))
    else:
        sf = jnp.broadcast_to(
            scalefac.reshape(nseg, SPS, 1), (nseg, SPS, W)
        ).reshape(nseg, SEG)

    # single-value tokens (incl. the single-zero byte 0)
    plain = (sv > -125) & (sv < 125)
    v16 = plane(1) | (plane(2) << 8)
    v16 = v16 - ((v16 >> 15) << 16)  # sign extend i16
    v24 = plane(1) | (plane(2) << 8) | (plane(3) << 16)
    v24 = v24 - ((v24 >> 23) << 24)
    f32bits = (
        plane(1) | (plane(2) << 8) | (plane(3) << 16) | (plane(4) << 24)
    )
    fraw = jax.lax.bitcast_convert_type(f32bits, jnp.float32)
    val1 = jnp.where(plain, sv, 0)
    val1 = jnp.where(sv == -125, v16, val1)
    val1 = jnp.where(sv == -127, v24, val1)
    val1f = val1.astype(jnp.float32)
    val1f = jnp.where(sv == -128, fraw, val1f)
    emit = (is_start == 1) & (plain | (sv == -125) | (sv == -127)
                              | (sv == -128))
    val = jnp.where(emit, val1f * sf, 0.0)
    pos = jnp.where(emit, out_base, 0)

    # group-of-8 tokens: unroll into per-carrier-byte emissions.  Carrier
    # q's value bytes are its own right neighbors; its start flag and
    # cursor come from static LEFT shifts of the token-start planes.
    start16 = (is_start == 1) & (sv == -126)
    start24 = (is_start == 1) & (sv == 126)
    base16 = jnp.where(start16, out_base, 0)
    base24 = jnp.where(start24, out_base, 0)

    def left_ext(x, fill):
        prev_tail = jnp.concatenate(
            [jnp.full((1, LOOK), fill, x.dtype), x[:-1, SEG - LOOK :]],
            axis=0,
        )
        return jnp.concatenate([prev_tail, x], axis=1)  # (nseg, LOOK+SEG)

    s16x = left_ext(start16, False)
    s24x = left_ext(start24, False)
    b16x = left_ext(base16, 0)
    b24x = left_ext(base24, 0)

    def shifted(xext, sh):
        return xext[:, LOOK - sh : LOOK - sh + SEG]

    cv16 = b0 | (plane(1) << 8)
    cv16 = cv16 - ((cv16 >> 15) << 16)
    cv24 = b0 | (plane(1) << 8) | (plane(2) << 16)
    cv24 = cv24 - ((cv24 >> 23) << 24)
    for j in range(8):
        m16 = shifted(s16x, 1 + 2 * j)
        emit = emit | m16
        val = jnp.where(m16, cv16.astype(jnp.float32) * sf, val)
        pos = jnp.where(m16, shifted(b16x, 1 + 2 * j) + j, pos)
        m24 = shifted(s24x, 1 + 3 * j)
        emit = emit | m24
        val = jnp.where(m24, cv24.astype(jnp.float32) * sf, val)
        pos = jnp.where(m24, shifted(b24x, 1 + 3 * j) + j, pos)

    emit = emit & (pos < CAP)
    return emit, val, pos




def _emit_and_scatter(M, e32, c32, vals_s, sv, Bx, scalefac, sub_block,
                      vol_shape, block):
    """Emit + scatter into the padded volume, in VOLUME order."""
    from . import wavelet

    nz, ny, nx = vol_shape
    bx, by, bz = block
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    nbx2 = wavelet.padded_nbx(nbx, bx)
    nzp, nyp, nxp = nbz * bz, nby * by, nbx2 * bx
    cells = bx * by * bz
    nseg = Bx.shape[0]
    total = nzp * nyp * nxp
    emit, val, pos = _emit_values(
        M, e32, c32, vals_s, sv, Bx, scalefac, cells
    )
    b = jnp.broadcast_to(
        sub_block.reshape(nseg, SPS, 1), (nseg, SPS, W)
    ).reshape(nseg, SEG)
    bzi = b // (nby * nbx)
    byi = (b // nbx) % nby
    bxi = b % nbx
    zl = pos // (by * bx)
    yl = (pos // bx) % by
    xl = pos % bx
    tgt = ((bzi * bz + zl) * nyp + (byi * by + yl)) * nxp \
        + bxi * bx + xl
    # dead entries go OUT of bounds (total+1 >= the (total+1,) scatter
    # buffer) so mode="drop" discards them instead of colliding on one
    # in-bounds dummy slot
    idx = jnp.where(emit, tgt, total + 1).reshape(-1)
    out = jnp.zeros((total + 1,), jnp.float32)
    # live targets are UNIQUE for any validated container: the cursor is
    # strictly increasing per emitted value within a block chain, each
    # block id appears once in the offset table, and blocks own disjoint
    # volume cells; dead entries are out of bounds and dropped.  Declaring
    # uniqueness lets XLA skip collision handling on the scatter.
    out = out.at[idx].set(val.reshape(-1), mode="drop", unique_indices=True)
    return out[:total].reshape(nzp * nyp, nxp)


@functools.partial(jax.jit, static_argnames=("nblocks", "block", "nseg_s"))
def decode_to_blocks(segs, sub_block, sub_reset, scalefac, nblocks, block,
                     nseg_s):
    """Device parse -> dense BLOCK-MAJOR coefficients (nblocks, cells).

    The multi-chip layer's per-shard form: block ids in `sub_block` are
    SHARD-LOCAL, the scatter target is the shard's block batch (no volume
    geometry involved), and the inverse wavelet runs on the batch.  All
    parse machinery is shared with decode_to_volume.
    """
    del nseg_s
    bx, by, bz = block
    cells = bx * by * bz
    M, e32, c32, vals_s, sv, Bx = _parse_stages(segs, sub_reset, cells)
    emit, val, pos = _emit_values(
        M, e32, c32, vals_s, sv, Bx, scalefac, cells
    )
    nseg = segs.shape[0]
    b = jnp.broadcast_to(
        sub_block.reshape(nseg, SPS, 1), (nseg, SPS, W)
    ).reshape(nseg, SEG)
    total = nblocks * cells
    tgt = b * cells + pos
    # dead -> out of bounds (dropped); live targets unique (see
    # _emit_and_scatter)
    idx = jnp.where(emit, tgt, total + 1).reshape(-1)
    out = jnp.zeros((total + 1,), jnp.float32)
    out = out.at[idx].set(val.reshape(-1), mode="drop", unique_indices=True)
    return out[:total].reshape(nblocks, cells)


@functools.partial(jax.jit, static_argnames=("vol_shape", "block"))
def overlay_raw(plane, raw_rows, raw_ids, vol_shape, block):
    """Scatter raw-fallback blocks' coefficients into the volume plane.

    Raw payloads are UNSCALED coefficients (CvxCompress.cpp:552-555: the
    decoder memcpys them, no scalefac) — scattered verbatim.
    """
    nz, ny, nx = vol_shape
    bx, by, bz = block
    from . import wavelet

    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    nyp = nby * by
    nxp = plane.shape[-1]  # may carry alignment x-padding (padded_nbx)
    cells = bx * by * bz
    b = raw_ids[:, None]
    pos = jnp.arange(cells, dtype=jnp.int32)[None, :]
    bzi = b // (nby * nbx)
    byi = (b // nbx) % nby
    bxi = b % nbx
    zl = pos // (by * bx)
    yl = (pos // bx) % by
    xl = pos % bx
    tgt = ((bzi * bz + zl) * nyp + (byi * by + yl)) * nxp + bxi * bx + xl
    flat = plane.reshape(-1)
    # distinct blocks own disjoint volume cells -> targets are unique
    flat = flat.at[tgt.reshape(-1)].set(
        raw_rows.reshape(-1), mode="drop", unique_indices=True
    )
    return flat.reshape(plane.shape)
