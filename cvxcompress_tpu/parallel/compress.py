"""Multi-device block-data-parallel compress/decompress (shard_map + pjit).

The device replacement for the reference's OpenMP fan-out
(CvxCompress.cpp:318): the (nnn, bz, by, bx) block batch shards along a 1D
device mesh; every device runs the identical SPMD program (matmul wavelet +
vectorized entropy encode + per-shard compaction).  The two cross-device
couplings of the algorithm:

  * global RMS — a sum reduction.  The API path computes it on host in f64
    (the container contract, see ops/quant.py); `distributed_sumsq` provides
    the on-device psum variant for device-resident volumes.
  * the payload byte-offset table — the reference serializes on an
    omp-critical byte cursor (CvxCompress.cpp:370-374, payload order
    nondeterministic); here per-block sizes flow through exclusive prefix
    sums (within shard on device, across shards on host), so the container
    is deterministic and bit-identical to the single-device path.

Containers produced under any mesh size are byte-identical to each other
and to the single-device backend (tested in tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from .. import container as ctn
from ..ops import blocks as blkops
from ..ops import quant, rle_device, wavelet
from . import mesh as meshlib

F32 = np.float32


def distributed_sumsq(vol_sharded, mesh):
    """On-device sum of squares with a psum all-reduce over the mesh.

    For volumes already resident/sharded on device.  f32 tree reduction —
    agrees with the host f64 contract to ~1e-6 relative; the API path keeps
    host f64 for container bit-stability.
    """

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=P(meshlib.BLOCK_AXIS), out_specs=P(),
        check_vma=False,
    )
    def _ss(shard):
        return jax.lax.psum(
            jnp.sum(jnp.square(shard.astype(jnp.float32))),
            meshlib.BLOCK_AXIS,
        )[None]

    return jax.jit(_ss)(vol_sharded)[0]


@functools.lru_cache(maxsize=None)
def _stage1(mesh, use_local, chunk):
    """Sharded forward wavelet + tokenize (PASS 1). Cached per (mesh, mode)."""
    spec_b = P(meshlib.BLOCK_AXIS)

    def run(blocks, glob_mf, scale):
        coeffs = wavelet.forward_3d(blocks)
        n = coeffs.shape[0]
        if use_local:
            mf = quant.mulfac_from_rms(quant.local_rms(coeffs), scale)
        else:
            mf = jnp.broadcast_to(glob_mf, (n,)).astype(jnp.float32)
        coeffs2d = coeffs.reshape(n, -1)
        cells = coeffs2d.shape[1]
        fv2d = (coeffs2d * mf[:, None]).astype(jnp.float32)
        nch = n * (cells // chunk)
        desc, chunk_bytes, sizes, raw, counts = rle_device.tokenize_desc(
            rle_device.as_rows(fv2d), n, chunk
        )
        # scaled chunks feed pack; unscaled chunks feed raw-block payloads
        return (fv2d.reshape(nch, chunk), coeffs2d.reshape(nch, chunk),
                desc, chunk_bytes, sizes, raw, mf, counts[None])

    sm = shard_map(
        run, mesh=mesh,
        in_specs=(P(meshlib.BLOCK_AXIS, None, None, None), P(), P()),
        out_specs=(spec_b,) * 7 + (P(meshlib.BLOCK_AXIS, None),),
        check_vma=False,
    )
    return jax.jit(sm)


@functools.lru_cache(maxsize=None)
def _stage2(mesh, chunk, acap, lcap):
    """Sharded per-shard packing (PASS 2) at static caps. Cached per config."""

    def run(fvchunks, desc, chunk_bytes):
        subrows, aidx, abytes = rle_device.pack_active(
            fvchunks, desc, chunk_bytes, acap, lcap
        )
        return subrows[None], aidx[None], abytes[None]

    sm = shard_map(
        run, mesh=mesh,
        in_specs=(
            P(meshlib.BLOCK_AXIS, None),
            P(meshlib.BLOCK_AXIS, None),
            P(meshlib.BLOCK_AXIS),
        ),
        out_specs=(
            P(meshlib.BLOCK_AXIS, None, None),
            P(meshlib.BLOCK_AXIS, None),
            P(meshlib.BLOCK_AXIS, None),
        ),
        check_vma=False,
    )
    return jax.jit(sm)


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, mesh=None):
    """Sharded compress. Container bit-identical to the single-device backend."""
    vol = np.ascontiguousarray(vol, dtype=F32)
    nz, ny, nx = vol.shape
    bx, by, bz = block
    assert ctn.is_valid_block_size(bx, by, bz), "invalid block size"
    cells = bx * by * bz
    if mesh is None:
        mesh = meshlib.make_mesh()
    n_shards = mesh.devices.size

    glob_mulfac = (
        F32(1.0)
        if use_local_rms
        else ctn.compute_glob_mulfac(quant.global_rms_host(vol), scale)
    )

    blocks = blkops.to_blocks_np(vol, block)
    nnn = blocks.shape[0]
    pad = meshlib.pad_to_shards(nnn, n_shards)
    if pad:
        blocks = np.concatenate(
            [blocks, np.zeros((pad,) + blocks.shape[1:], dtype=F32)]
        )
    blocks_d = jax.device_put(blocks, meshlib.block_sharding(mesh))
    chunk = rle_device.chunk_cells(cells)
    ncpb = cells // chunk

    fvchunks, cchunks, desc, chunk_bytes, sizes, raw, mf, counts = _stage1(
        mesh, use_local_rms, chunk
    )(blocks_d, jnp.float32(glob_mulfac), jnp.float32(scale))
    # count-only readback (8 bytes/shard) — NO d2h proportional to raw
    # size; the chunk table stays on device (same discipline as the
    # single-device path's tokenize_desc counts)
    counts_h = np.asarray(counts)
    sizes_h = np.asarray(sizes)
    raw_h = np.asarray(raw)[:nnn]

    # uniform static caps = max over shards (SPMD requires identical shapes)
    acap = rle_device.bucket(int(counts_h[:, 0].max()))
    lcap = rle_device.bucket(int(counts_h[:, 1].max()))

    subrows, aidx, abytes = (
        np.asarray(v)
        for v in _stage2(mesh, chunk, acap, lcap)(fvchunks, desc, chunk_bytes)
    )

    # per-shard compacted metadata -> one global sorted (aidx, abytes)
    # stream; shards are contiguous block ranges so concatenation keeps
    # global chunk order.  Pad blocks are all-zero -> never active.
    bps = blocks.shape[0] // n_shards
    g_aidx, g_ab, parts = [], [], []
    for s in range(n_shards):
        a_s = int(counts_h[s, 0])
        idx_s = aidx[s, :a_s].astype(np.int64) + s * bps * ncpb
        ab_s = abytes[s, :a_s]
        # pad blocks (all-zero, trailing) still emit run tokens; their
        # chunks sit at the shard tail — truncate them and their subrows
        keep = int(np.searchsorted(idx_s, nnn * ncpb))
        g_aidx.append(idx_s[:keep])
        g_ab.append(ab_s[:keep])
        nlive = int(((ab_s[:keep] + rle_device.SUBROW - 1)
                     // rle_device.SUBROW).sum())
        parts.append(subrows[s, :nlive])
    flat = (
        np.concatenate(parts)
        if parts
        else np.zeros((0, rle_device.SUBROW), np.uint8)
    )
    g_aidx = np.concatenate(g_aidx) if g_aidx else np.zeros(0, np.int64)
    g_ab = np.concatenate(g_ab) if g_ab else np.zeros(0, np.int64)

    raw_bytes_h = None
    if raw_h.any():
        rblk = np.nonzero(raw_h)[0].astype(np.int32)
        ridx = (rblk[:, None] * ncpb + np.arange(ncpb, dtype=np.int32)).ravel()
        raw_bytes_h = (
            np.asarray(
                jax.jit(lambda m, i: jnp.take(m, i, axis=0))(
                    cchunks, jnp.asarray(ridx)
                )
            )
            .reshape(rblk.size, cells)
            .view(np.uint8)
        )

    stream, _total = rle_device.assemble_payload_sparse(
        flat, g_aidx, g_ab, g_aidx.size, sizes_h[:nnn], raw_h, raw_bytes_h,
        cells, chunk,
    )

    hdr = ctn.Header(nx, ny, nz, bx, by, bz, glob_mulfac, use_local_rms)
    data = ctn.pack_stream(
        hdr, sizes_h[:nnn], raw_h, stream,
        np.asarray(mf)[:nnn] if use_local_rms else None,
    )
    ratio = (nx * ny * nz * 4) / data.size
    return data, ratio


@functools.lru_cache(maxsize=None)
def _inv_stage(mesh):
    def run(coeff_blocks):
        return wavelet.inverse_3d(coeff_blocks)

    sm = shard_map(
        run, mesh=mesh,
        in_specs=P(meshlib.BLOCK_AXIS, None, None, None),
        out_specs=P(meshlib.BLOCK_AXIS, None, None, None),
        check_vma=False,
    )
    return jax.jit(sm)


@functools.lru_cache(maxsize=None)
def _decode_inv_stage(mesh, block, bps, sseg):
    """Per-shard DEVICE entropy parse + inverse wavelet (SPMD).

    Each shard parses its own segment slice (block ids shard-local) into a
    dense block batch and inverts it — the multi-device twin of the
    single-device device-complete decompress.
    """
    from ..ops import entropy_decode as ed

    bx, by, bz = block

    def run(segs, sblk, srst, ssf):
        dense = ed.decode_to_blocks.__wrapped__(
            segs[0], sblk[0], srst[0], ssf[0], bps, (bx, by, bz), sseg,
        )
        out = wavelet.inverse_3d(dense.reshape(bps, bz, by, bx))
        return out[None]

    sm = shard_map(
        run, mesh=mesh,
        in_specs=(
            P(meshlib.BLOCK_AXIS, None, None),
            P(meshlib.BLOCK_AXIS, None),
            P(meshlib.BLOCK_AXIS, None),
            P(meshlib.BLOCK_AXIS, None),
        ),
        out_specs=P(meshlib.BLOCK_AXIS, None, None, None),
        check_vma=False,
    )
    return jax.jit(sm)


def _shard_decode_plan(data, nnn, cells, n_shards):
    """Host: global segment plan -> per-shard slices (rebased block ids).

    Returns None when the container needs the host decoder (raw blocks or
    degenerate spans).  Subsegments are block-sorted, so each shard's
    slice is one contiguous run; slices pad to a uniform whole-row count
    with inert rows (local block id = bps -> scatter targets discard).

    Shard boundaries are SUBSEGMENT-balanced, not block-count-balanced:
    SPMD pads every shard to the largest shard's parse size, so with
    skewed payloads the expensive side (the entropy parse, cost ∝
    subsegments) is what must be equalized; the dense block batch pads to
    the max per-shard block count instead (zero blocks — near-free).
    """
    from ..ops import entropy_decode as ed

    p = ed.plan(data)
    if p is None or p["raw_ids"].size:
        return None
    sub_block = p["sub_block"]
    subs32 = p["segs"].reshape(-1, ed.W)
    nsub_real = int(np.searchsorted(sub_block, nnn, side="left"))
    # block-aligned boundaries equalizing subsegments per shard (a
    # block's subsegment run never splits across shards)
    targets = (np.arange(1, n_shards) * nsub_real) // n_shards
    cut = sub_block[np.minimum(targets, max(nsub_real - 1, 0))] \
        if nsub_real else np.zeros(n_shards - 1, np.int64)
    bstart = np.concatenate([[0], cut, [nnn]]).astype(np.int64)
    bstart = np.maximum.accumulate(bstart)  # monotone for tiny inputs
    bounds = np.searchsorted(sub_block, bstart, side="left")
    counts = np.diff(bounds)
    bps = max(int(np.diff(bstart).max()), 1)
    smax = -(-int(counts.max()) // ed.SPS) * ed.SPS  # whole 512-B rows
    smax = max(smax, ed.SPS)
    scalefac = p["scalefac"]
    if scalefac.shape[0] == 1:  # global-RMS scalar form (see ed.plan)
        scalefac = np.broadcast_to(scalefac, (subs32.shape[0],))
    segs = np.zeros((n_shards, smax // ed.SPS, ed.SEG), np.uint8)
    sblk = np.full((n_shards, smax), bps, np.int32)
    srst = np.ones((n_shards, smax), bool)
    ssf = np.ones((n_shards, smax), np.float32)
    for s in range(n_shards):
        r0, r1 = int(bounds[s]), int(bounds[s + 1])
        k = r1 - r0
        segs[s].reshape(-1, ed.W)[:k] = subs32[r0:r1]
        sblk[s, :k] = sub_block[r0:r1] - bstart[s]
        srst[s, :k] = p["sub_reset"][r0:r1]
        ssf[s, :k] = scalefac[r0:r1]
    return {
        "segs": segs, "sblk": sblk, "srst": srst, "ssf": ssf,
        "bps": bps, "sseg": smax // ed.SPS, "bstart": bstart,
    }


def decompress(data, mesh=None):
    """Sharded decompress with the DEVICE entropy parse per shard.

    On a single-device mesh this delegates to the device-complete
    single-device engine; on several devices each shard parses its own segment
    slice (ops.entropy_decode through shard_map) and inverts its block
    batch — only the container parse and the per-shard segment memcpy run
    on host.  Containers with raw-fallback blocks take the host-decode
    path.
    """
    hdr, blkoffs, blkmulfac, payload_base = ctn.unpack(data)
    if mesh is None:
        mesh = meshlib.make_mesh()
    n_shards = mesh.devices.size
    if n_shards == 1:
        from ..ops import codec as _codec

        return _codec.decompress(data)
    block = (hdr.bx, hdr.by, hdr.bz)
    cells = hdr.bx * hdr.by * hdr.bz
    nnn = hdr.grid[3]

    sp = _shard_decode_plan(data, nnn, cells, n_shards)
    if sp is not None:
        sh = jax.sharding.NamedSharding(mesh, P(meshlib.BLOCK_AXIS))
        args = [
            jax.device_put(sp[k], sh) for k in ("segs", "sblk", "srst", "ssf")
        ]
        ob = np.asarray(
            _decode_inv_stage(mesh, block, sp["bps"], sp["sseg"])(*args)
        ).reshape(n_shards, sp["bps"], hdr.bz, hdr.by, hdr.bx)
        bstart = sp["bstart"]
        out_blocks = np.concatenate([
            ob[s, : bstart[s + 1] - bstart[s]] for s in range(n_shards)
        ])
        return blkops.from_blocks_np(
            out_blocks, (hdr.nz, hdr.ny, hdr.nx), block
        )

    from ..ops.codec import _decode_payloads_host

    coeffs = _decode_payloads_host(data, hdr, blkoffs, blkmulfac, payload_base)
    pad = meshlib.pad_to_shards(nnn, n_shards)
    if pad:
        coeffs = np.concatenate(
            [coeffs, np.zeros((pad, coeffs.shape[1]), dtype=F32)]
        )
    cb = coeffs.reshape(-1, hdr.bz, hdr.by, hdr.bx)
    cb_d = jax.device_put(cb, meshlib.block_sharding(mesh))
    out_blocks = np.asarray(_inv_stage(mesh)(cb_d))[:nnn]
    return blkops.from_blocks_np(
        out_blocks, (hdr.nz, hdr.ny, hdr.nx), (hdr.bx, hdr.by, hdr.bz)
    )
