"""Device entropy encoder: quantize + RLE/escape grammar, sparsify-then-pack.

The reference encoder (Run_Length_Encode_Slow.cpp:189-294) is a sequential
byte emitter with a mutable run-length register and a byte cursor.  A
data-parallel device has no sequential byte cursor, so the encoder is
reformulated so that every data-dependent movement happens at chunk-row
granularity and all variable-length packing uses the monotone log-shift
primitive (ops/pack.py):

 PASS 1 — tokenize_desc, full-size, O(cells):
   quantize + classify every cell, pick the group-of-8 fast-path modes with
   the reference's exact selection guards (Run_Length_Encode_Slow.cpp:216,
   231,246), detect zero runs (hierarchical cummax with per-block carry;
   the run token lands on the run's LAST zero cell, matching the deferred
   EncodeRLE_Slow flush), and emit ONE packed int32 descriptor per cell:
   desc = cost(3b) | run_end(1b) | min(run_len, 2^24-1)(24b).
   Per-chunk byte counts, per-block sizes and the raw-fallback flags
   (stream > 4*cells -> raw block, CvxCompress.cpp:350-360) fall out of a
   row-sum.  Zero runs >= 2^24 split (cost-5 token [RLESC3 FFFFFF][0]).

 PASS 2 — pack_active, O(active chunks):
   chunks with zero payload bytes (interior of long zero runs, raw blocks)
   are dropped by log-shift compacting the chunk index list; only ACTIVE
   chunks are row-gathered.  Their 5 byte-planes are recomputed from the
   gathered coefficients + descriptors, interleaved into a cell-major
   (A, 5Q) staging, and front-packed per row by a 12-round log-shift
   (distance of byte (i,k) is 5i - off_i, monotone).  The packed rows are
   cut into 64-byte subrows and the live subrows are row-gathered into the
   final (L, 64) buffer — device->host traffic is ~1-2x the compressed
   size, never the raw size.

 HOST — assemble_payload: ragged concat of per-chunk payloads (numpy
   fancy-index, ∝ compressed bytes) + raw-block coefficient bytes ->
   the exact reference payload stream, block-ordered.

The emitted stream is byte-identical to the NumPy oracle encoder (and hence
to the reference grammar) — tested in tests/test_rle_device.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import pack, quant

I32 = jnp.int32
U8 = jnp.uint8

MAX_RUN24 = (1 << 24) - 1
SUBROW = 64

_B_RLESC1 = 127
_B_RLESC3 = 125
_B_VLESC2 = 0x83
_B_VLESC3 = 0x81
_B_VLESC4 = 0x80
_B_VLESC2_8X = 0x82
_B_VLESC3_8X = 0x7E


def chunk_cells(cells):
    """Chunk size Q: 128 cells, or the whole block when smaller.

    Q trades chunk-grid overhead against wasted staging in active chunks.
    Wavelet-coefficient sparsity is row-structured (nonzeros cluster at the
    low-x end of each (y,z) row), so fine chunks keep the active staging
    ∝ compressed size even for axis-degenerate fields (measured: Q=512
    marks every other chunk active on a z-only sinusoid; Q=128 tracks the
    true support).
    """
    return min(128, int(cells))


def _byte(v, k):
    """k-th little-endian byte of an int32 array, as int32 in [0,255]."""
    return jax.lax.shift_right_logical(v, jnp.int32(8 * k)) & 0xFF


def _sel(*pairs_and_default):
    """where-cascade: _sel(c1, v1, c2, v2, ..., default)."""
    out = pairs_and_default[-1]
    for i in range(len(pairs_and_default) - 3, -1, -2):
        out = jnp.where(pairs_and_default[i], pairs_and_default[i + 1], out)
    return out


def _classify(iv):
    """Nested size classes of quantized values (Run_Length_Encode_Slow.cpp)."""
    izero = iv == 0
    is_byte = (iv > -125) & (iv < 125)  # zero lanes count, as in ref :215
    is_short = (iv >= -32768) & (iv <= 32767)
    is_i3 = (iv >= -8388608) & (iv <= 8388607)
    return izero, is_byte, is_short, is_i3


def _group_modes(izero, is_byte, is_short, is_i3, shape2):
    """Group-of-8 fast-path mode per cell: 0 none / 1 byte / 2 short / 3 i24.

    One packed base-16 reshape-sum provides all four group counts
    (each count <= 8 fits a nibble); selection guards match the reference
    (:216 all-byte, :231 8x-short, :246 8x-int24).
    """
    n, c = shape2
    code = (
        izero.astype(I32)
        + (is_byte.astype(I32) << 4)
        + (is_short.astype(I32) << 8)
        + (is_i3.astype(I32) << 12)
    )
    g = code.reshape(n, c // 8, 8).sum(-1)
    nzero = g & 15
    nb = (g >> 4) & 15
    ns = (g >> 8) & 15
    n3 = (g >> 12) & 15
    nozero = nzero == 0
    allbyte = nozero & (nb == 8)
    allshort = nozero & ~allbyte & (ns == 8) & (nb + (8 - nb) * 3 > 17)
    alli3 = (
        nozero & ~allbyte & ~allshort & (n3 == 8)
        & (nb + (ns - nb) * 3 + (8 - ns) * 4 > 25)
    )
    mode = _sel(allbyte, 1, allshort, 2, alli3, 3, 0).astype(I32)
    mode = jnp.broadcast_to(mode[:, :, None], (n, c // 8, 8)).reshape(n, c)
    return mode


ROW = 32768  # tokenize compute-row width


def row_cells(cells):
    """Super-row width for the tokenize layout (divides cells)."""
    return min(ROW, int(cells))


def as_rows(coeffs2d):
    """(N, cells) -> (nrows, row) canonical tokenize compute layout."""
    n, c = coeffs2d.shape
    row = row_cells(c)
    return coeffs2d.reshape(n * (c // row), row)


def _run_structure(member, nblocks, rpb, row):
    """(run_end, run_len) with per-block reset, hierarchical cummax.

    Operates on the canonical (nrows, ROW) layout.  A run's token is
    attached to its LAST zero cell.  last-nonmember indices are computed
    per row (minor-axis cummax) and carried across the rows of the same
    block by a small cummax over the row axis (the data-parallel version
    of the encoder's sequential run register).
    """
    nrows = nblocks * rpb
    rib = (jnp.arange(nrows, dtype=I32) % rpb)[:, None]  # row-in-block
    idx = jnp.arange(row, dtype=I32)[None, :] + rib * row  # within-block
    lnm = jnp.where(member, I32(-1), idx)
    local = jax.lax.cummax(lnm, axis=1)
    row_max = local[:, -1].reshape(nblocks, rpb)
    carry = jax.lax.cummax(row_max, axis=1)
    carry = jnp.concatenate(
        [jnp.full((nblocks, 1), -1, I32), carry[:, :-1]], axis=1
    ).reshape(nrows, 1)
    lastnm = jnp.where(local == -1, carry, local)

    # next cell's membership, looking across the row boundary (but not
    # across block boundaries: each block's trailing run ends at its end)
    nxt_first = jnp.concatenate(
        [member[1:, :1], jnp.zeros((1, 1), dtype=bool)], axis=0
    )
    last_of_block = (rib == rpb - 1)[:, :1]
    nxt = jnp.concatenate(
        [member[:, 1:], jnp.where(last_of_block, False, nxt_first)], axis=1
    )
    run_end = member & ~nxt
    run_len = idx - lastnm
    return run_end, run_len


def _cost(mode, izero, is_byte, is_short, is_i3, run_end, run_len):
    """Per-cell emission size in bytes (0 for non-final zeros)."""
    lane0 = (jnp.arange(izero.shape[-1], dtype=I32) % 8 == 0)[None, :]
    cb = is_byte & ~izero
    cs = is_short & ~is_byte
    c3 = is_i3 & ~is_short
    runcost = _sel(
        run_len == 1, 1,
        run_len < 256, 2,
        run_len <= MAX_RUN24, 4,
        5,  # split case: [RLESC3 FFFFFF][0]
    )
    return _sel(
        mode == 1, 1,
        mode == 2, jnp.where(lane0, 3, 2),
        mode == 3, jnp.where(lane0, 4, 3),
        izero, jnp.where(run_end, runcost, 0),
        cb, 1,
        cs, 3,
        c3, 4,
        5,
    ).astype(I32)


@functools.partial(jax.jit, static_argnames=("nblocks", "chunk"))
def tokenize_desc(fv_rows, nblocks, chunk):
    """PASS 1: per-cell descriptors + per-chunk/per-block byte accounting.

    fv_rows (nrows, row) f32: PRE-SCALED coefficients (mulfac * coeff) in
    the canonical compute layout (`as_rows`); chunk static (divides
    cells).  Returns:
      desc        (N*cells//chunk, chunk) int32   cost|run_end|run_len
      chunk_bytes (N*cells//chunk,)       int32   0 for raw blocks
      sizes       (N,) int32   per-block payload size (4*cells when raw)
      raw         (N,) bool    raw-fallback flag (CvxCompress.cpp:350-360)

    The codec feeds it the (nrows, row_cells) output of the wavelet
    stage's own jit (codec._stage_w).
    """
    n = nblocks
    nrows, row = fv_rows.shape
    rpb = nrows // n
    c = rpb * row
    assert c % chunk == 0 and chunk % 8 == 0
    ncpb = c // chunk
    nchunks = n * ncpb
    _, iv = quant.quantize(fv_rows, jnp.float32(1.0))
    izero, is_byte, is_short, is_i3 = _classify(iv)
    mode = _group_modes(izero, is_byte, is_short, is_i3, (nrows, row))
    run_end, run_len = _run_structure(izero, n, rpb, row)
    cost = _cost(mode, izero, is_byte, is_short, is_i3, run_end, run_len)

    desc = (
        cost
        | (run_end.astype(I32) << 3)
        | (jnp.minimum(run_len, MAX_RUN24) << 4)
    )

    chunk_bytes = cost.reshape(n, ncpb, chunk).sum(-1)
    sizes0 = chunk_bytes.sum(-1)
    raw = sizes0 > 4 * c
    sizes = jnp.where(raw, I32(4 * c), sizes0)
    chunk_bytes = jnp.where(raw[:, None], I32(0), chunk_bytes)
    # counts for host capacity planning: an 8-byte readback instead of the
    # full (nchunks,) table
    active = chunk_bytes > 0
    acount = active.sum(dtype=I32)
    lcount = ((chunk_bytes + (SUBROW - 1)) // SUBROW).sum(dtype=I32)
    counts = jnp.stack([acount, lcount])
    return (
        desc.reshape(nchunks, chunk),
        chunk_bytes.reshape(nchunks),
        sizes,
        raw,
        counts,
    )


def _planes(cf, iv, fv, desc, mode, izero, is_byte, is_short, is_i3):
    """The 5 byte-planes of every cell's <=5-byte token (active rows only).

    Byte values replicate the oracle/reference grammar exactly
    (Run_Length_Escape_Codes.hxx:8-14); packed groups decompose per lane
    (VLESC2_8x = lane0 [code,i16] + lanes1..7 [i16], byte-identical).
    """
    cost = desc & 7
    run_end = (desc >> 3) & 1
    rl = jax.lax.shift_right_logical(desc, 4)
    lane0 = (jnp.arange(iv.shape[-1], dtype=I32) % 8 == 0)[None, :]
    pb, ps, p3 = mode == 1, mode == 2, mode == 3
    member = izero
    cb = is_byte & ~izero
    cs = is_short & ~is_byte
    c3 = is_i3 & ~is_short
    big = rl >= 256
    split = member & (cost == 5)

    fvb = jax.lax.bitcast_convert_type(fv, I32)

    plane0 = _sel(
        pb, _byte(iv, 0),
        ps, jnp.where(lane0, _B_VLESC2_8X, _byte(iv, 0)),
        p3, jnp.where(lane0, _B_VLESC3_8X, _byte(iv, 0)),
        member, _sel((rl == 1) & ~split, 0, big | split, _B_RLESC3, _B_RLESC1),
        cb, _byte(iv, 0),
        cs, _B_VLESC2,
        c3, _B_VLESC3,
        _B_VLESC4,
    )
    plane1 = _sel(
        ps, jnp.where(lane0, _byte(iv, 0), _byte(iv, 1)),
        p3, jnp.where(lane0, _byte(iv, 0), _byte(iv, 1)),
        member, _byte(rl, 0),
        cb | pb, 0,
        cs | c3, _byte(iv, 0),
        _byte(fvb, 0),
    )
    plane2 = _sel(
        ps, _byte(iv, 1),  # only read for lane0 (cost 3)
        p3, jnp.where(lane0, _byte(iv, 1), _byte(iv, 2)),
        member, _byte(rl, 1),
        cs | c3, _byte(iv, 1),
        _byte(fvb, 1),
    )
    plane3 = _sel(
        p3, _byte(iv, 2),  # only read for lane0 (cost 4)
        member, _byte(rl, 2),
        c3, _byte(iv, 2),
        _byte(fvb, 2),
    )
    plane4 = _sel(
        member, 0,  # split-run trailing single zero
        _byte(fvb, 3),
    )
    return plane0, plane1, plane2, plane3, plane4, cost


def _fit(a, cap, fill=0):
    """Static slice-or-pad of a 1-D array to length cap."""
    n = a.shape[0]
    if cap <= n:
        return a[:cap]
    pad = jnp.full((cap - n,), fill, dtype=a.dtype)
    return jnp.concatenate([a, pad])


@functools.partial(jax.jit, static_argnames=("acap", "lcap", "skip_squeeze"))
def pack_active(fv_chunks, desc, chunk_bytes, acap, lcap, skip_squeeze=False):
    """PASS 2: row-gather active chunks, pack their payload bytes.

    fv_chunks (nchunks, chunk) f32: PRE-SCALED coefficients in chunk
    layout, desc/chunk_bytes from tokenize_desc.  acap/lcap: static
    buckets >= the active-chunk / live-subrow counts (host-chosen).
    Returns (subrows (lcap, SUBROW) u8, aidx, abytes); live subrows hold
    the per-chunk payloads, front-packed, in block order.
    """
    nchunks, chunk = desc.shape

    # -- active-chunk scalar compaction (index + bytes stacked into one
    # 2-row array: one compaction instead of two)
    live = chunk_bytes > 0
    cidx = jnp.arange(nchunks, dtype=I32)
    stacked = jnp.stack([cidx, chunk_bytes])
    packed2, count2 = pack.compact_live(
        (stacked,), jnp.broadcast_to(live, (2, nchunks)),
        pack.ceil_log2(nchunks),
    )
    count = count2[0]
    aidx = _fit(
        jnp.where(jnp.arange(nchunks, dtype=I32) < count, packed2[0][0], 0),
        acap,
    )
    abytes = _fit(
        jnp.where(jnp.arange(nchunks, dtype=I32) < count, packed2[0][1], 0),
        acap,
    )

    # -- row-gather active chunks, rebuild their token bytes
    fvg = jnp.take(fv_chunks, aidx, axis=0)
    dsc = jnp.take(desc, aidx, axis=0)
    fv, iv = quant.quantize(fvg, jnp.float32(1.0))
    izero, is_byte, is_short, is_i3 = _classify(iv)
    mode = _group_modes(izero, is_byte, is_short, is_i3, (acap, chunk))
    p0, p1, p2, p3_, p4, cost = _planes(
        fvg, iv, fv, dsc, mode, izero, is_byte, is_short, is_i3
    )

    # -- cell-major staging (A, 5Q) and monotone front-pack
    staging = jnp.stack(
        [p.astype(U8) for p in (p0, p1, p2, p3_, p4)], axis=-1
    ).reshape(acap, 5 * chunk)
    off = jnp.cumsum(cost, axis=1) - cost
    base = 5 * jnp.arange(chunk, dtype=I32)[None, :] - off  # dist per cell
    kio = jnp.arange(5, dtype=I32)[None, None, :]
    livb = kio < cost[:, :, None]
    ddt = jnp.int16 if 5 * chunk <= 32767 else I32  # halve logshift traffic
    dist = jnp.where(
        livb, jnp.broadcast_to(base[:, :, None], (acap, chunk, 5)), -1
    ).astype(ddt).reshape(acap, 5 * chunk)
    packed, _ = pack.compact_rows(staging, dist, pack.ceil_log2(5 * chunk))
    if skip_squeeze:
        # every live entry has exactly one subrow (acount == lcount): the
        # squeeze is the identity on the first SUBROW columns
        return packed[:, :SUBROW], aidx, abytes
    return _subrow_squeeze(packed, abytes, acap, lcap, chunk, aidx)


def _subrow_squeeze(packed, abytes, acap, lcap, chunk, aidx):
    """Live-subrow selection + row-gather (d2h ∝ compressed bytes)."""
    spq = 5 * chunk // SUBROW
    nsub = (abytes + (SUBROW - 1)) // SUBROW  # ceil(s/64) per active chunk
    sub_live = (
        jnp.arange(spq, dtype=I32)[None, :] < nsub[:, None]
    ).reshape(acap * spq)
    sidx = jnp.arange(acap * spq, dtype=I32)
    (lidx,), lcount = pack.compact_live(
        (sidx,), sub_live, pack.ceil_log2(acap * spq)
    )
    lidx = _fit(
        jnp.where(jnp.arange(acap * spq, dtype=I32) < lcount, lidx, 0), lcap
    )
    subrows = jnp.take(packed.reshape(acap * spq, SUBROW), lidx, axis=0)
    # compacted per-active-chunk metadata rides along so the host never
    # needs the full (nchunks,) table (readbacks scale with compressed size)
    return subrows, aidx, abytes


def bucket(n, lo=8):
    """Round up to a quarter-step capacity (1, 1.25, 1.5, 1.75 x 2^k).

    Buckets bound jit recompiles across a volume stream; quarter steps
    keep the expected capacity overshoot ~11% (power-of-two buckets
    averaged ~33%, and every downstream pack/gather/staging pass scales
    with the cap) at the cost of at most 4x more cached programs.
    """
    n = max(int(n), lo)
    k = max(int(np.floor(np.log2(n))) - 2, 0)
    return ((n + (1 << k) - 1) >> k) << k


def plan_capacities(chunk_bytes_h):
    """Host-side: (acap, lcap) buckets from the pass-1 chunk byte counts."""
    active = chunk_bytes_h > 0
    acount = int(np.count_nonzero(active))
    lcount = int(((chunk_bytes_h[active] + SUBROW - 1) // SUBROW).sum())
    return bucket(acount), bucket(lcount)


def assemble_payload_sparse(subrows_h, aidx_h, abytes_h, acount, sizes_h,
                            raw_h, raw_bytes_h, cells, chunk):
    """Host: ragged-concat from COMPACTED per-active-chunk metadata.

    subrows_h (lcap, SUBROW) u8, aidx_h/abytes_h (acap,) from pack_active
    (only the first `acount` entries are live), sizes/raw per block.
    Everything here is ∝ compressed size.  Returns (stream uint8, total).
    """
    sizes = np.asarray(sizes_h, dtype=np.int64)
    raw = np.asarray(raw_h, dtype=bool)
    aidx = np.asarray(aidx_h[:acount], dtype=np.int64)
    ab = np.asarray(abytes_h[:acount], dtype=np.int64)
    ncpb = cells // chunk

    total = int(sizes.sum())
    stream = np.empty(total, dtype=np.uint8)
    block_base = np.cumsum(sizes) - sizes

    if acount:
        blk = aidx // ncpb
        excl = np.cumsum(ab) - ab
        # within-block prefix: excl minus the excl at the block's first
        # active chunk (groupwise broadcast via maximum.accumulate)
        first = np.empty(acount, dtype=bool)
        first[0] = True
        np.not_equal(blk[1:], blk[:-1], out=first[1:])
        start_excl = np.maximum.accumulate(np.where(first, excl, 0))
        dst = block_base[blk] + (excl - start_excl)

        nsub = (ab + SUBROW - 1) // SUBROW
        src = (np.cumsum(nsub) - nsub) * SUBROW

        flat = np.ascontiguousarray(subrows_h, dtype=np.uint8).reshape(-1)
        # (the stream is already byte-dense; `flat` keeps the name the
        # ragged copy helpers expect)
        try:
            from . import rle_host

            native = rle_host.available()
        except Exception:
            native = False
        if native:
            # per-chunk memcpys in C++ (~10x the numpy fancy-index copy)
            from . import rle_host

            rle_host.ragged_copy(flat, src, stream, dst, ab)
        else:
            tot_rle = int(ab.sum())
            sidx = np.repeat(src - excl, ab) + np.arange(tot_rle)
            didx = np.repeat(dst - excl, ab) + np.arange(tot_rle)
            stream[didx] = flat[sidx]

    if raw.any():
        rb = np.ascontiguousarray(raw_bytes_h, dtype=np.uint8)
        for i, b in enumerate(np.nonzero(raw)[0]):
            stream[block_base[b] : block_base[b] + 4 * cells] = rb[i]
    return stream, total


def assemble_payload(subrows_h, chunk_bytes_h, sizes_h, raw_h, raw_bytes_h,
                     cells, chunk):
    """Host: ragged-concat per-chunk payloads into the reference stream.

    subrows_h (lcap, SUBROW) u8 from pack_active; chunk_bytes_h (nchunks,)
    in block order; raw_bytes_h (n_raw, 4*cells) u8 rows for raw blocks in
    block order.  Returns (stream uint8, total) — the payload area content.
    All numpy work is ∝ compressed size (fancy-index ragged copy).
    """
    sizes = np.asarray(sizes_h, dtype=np.int64)
    raw = np.asarray(raw_h, dtype=bool)
    cb = np.asarray(chunk_bytes_h, dtype=np.int64)
    ncpb = cells // chunk
    n = sizes.size

    total = int(sizes.sum())
    stream = np.empty(total, dtype=np.uint8)

    # destination offset of every chunk: block base + within-block prefix
    block_base = np.cumsum(sizes) - sizes
    within = cb.reshape(n, ncpb)
    within = np.cumsum(within, axis=1) - within
    dst = (block_base[:, None] + within).reshape(-1)

    # source offset of every active chunk in the flat subrow buffer
    nsub = (cb + SUBROW - 1) // SUBROW
    src = (np.cumsum(nsub) - nsub) * SUBROW

    if cb.sum():
        flat = np.ascontiguousarray(subrows_h, dtype=np.uint8).reshape(-1)
        # (the stream is already byte-dense; `flat` keeps the name the
        # ragged copy helpers expect)
        tot_rle = int(cb.sum())
        # gather indices: for chunk q, flat[src_q : src_q + s_q]
        sidx = np.repeat(src - (np.cumsum(cb) - cb), cb) + np.arange(tot_rle)
        didx = np.repeat(dst - (np.cumsum(cb) - cb), cb) + np.arange(tot_rle)
        stream[didx] = flat[sidx]

    if raw.any():
        rb = np.ascontiguousarray(raw_bytes_h, dtype=np.uint8)
        for i, b in enumerate(np.nonzero(raw)[0]):
            stream[block_base[b] : block_base[b] + 4 * cells] = rb[i]
    return stream, total
