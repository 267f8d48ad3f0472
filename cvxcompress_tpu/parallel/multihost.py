"""Multi-host driver for sharded compression (jax.distributed).

Each host owns a contiguous z-slab of blocks (parallel.sharded.plan_shards)
and runs the single-host pipeline on its local devices; the only
cross-host traffic is an 8-byte sum-of-squares all-reduce before
compression and the segment gather at the end (over the host network),
matching the two global couplings identified in SURVEY.md §2.

On one GPU host a single process drives all local cards (one volume over
four cards is parallel.compress on a make_mesh() of them); this module is
for several hosts, one process per host.  It is off the main path.

Usage (one process per host, standard JAX multi-process setup):

    import jax
    jax.distributed.initialize(coordinator, num_processes, process_id)
    data = multihost.compress(local_slab, scale, block)   # on process 0

Two gather strategies:
  * `gather="allgather"` — segments travel between hosts via
    jax.experimental.multihost_utils; process 0 merges and returns the
    container (other processes return None).
  * `gather="files"` — each host writes `<prefix>.seg<k>`; merging is a
    separate metadata-plus-concat step (`merge_segment_files`), the
    practical pattern for snapshot archives on shared storage.

This module is exercised in CI in its degenerate single-process form
(tests/test_sharded.py covers the shard/merge math byte-for-byte); the
multi-process paths follow stock JAX collectives.
"""

from __future__ import annotations

import numpy as np

from . import sharded


def _pcount():
    import jax

    return jax.process_count(), jax.process_index()


def compress(local_slab, scale, block=(32, 32, 32), use_local_rms=False,
             vol_shape=None, gather="allgather", file_prefix=None):
    """Compress this host's z-slab; gather and merge on process 0.

    `local_slab` is this host's contiguous z-slab (block-aligned except
    possibly the last host).  `vol_shape` is the GLOBAL volume shape
    (required when process_count > 1).
    """
    import jax

    nproc, pid = _pcount()
    local_slab = np.ascontiguousarray(local_slab, dtype=np.float32)
    if vol_shape is None:
        assert nproc == 1, "vol_shape required under multi-process"
        vol_shape = local_slab.shape

    if use_local_rms:
        glob_mulfac = np.float32(1.0)
    else:
        ss_local = sharded.partial_sumsq(local_slab)
        if nproc > 1:
            from jax.experimental import multihost_utils as mhu

            ss_total = float(
                mhu.process_allgather(np.asarray([ss_local])).sum()
            )
        else:
            ss_total = ss_local
        glob_mulfac = sharded.mulfac_from_sumsq(
            ss_total, int(np.prod(vol_shape)), scale
        )

    segment = sharded.compress_shard(
        local_slab, scale, block, glob_mulfac, use_local_rms
    )

    if gather == "files":
        assert file_prefix, "file_prefix required for gather='files'"
        path = f"{file_prefix}.seg{pid}"
        segment.tofile(path)
        return path

    if nproc == 1:
        return sharded.merge_segments(
            [segment], vol_shape, block, glob_mulfac, use_local_rms
        )

    from jax.experimental import multihost_utils as mhu

    # pad segments to the max length for the fixed-shape allgather, carry
    # true lengths alongside
    ln = np.asarray([segment.size])
    lens = mhu.process_allgather(ln).ravel()
    cap = int(lens.max())
    padded = np.zeros(cap, np.uint8)
    padded[: segment.size] = segment
    all_segs = mhu.process_allgather(padded)
    if pid != 0:
        return None
    segments = [all_segs[p, : int(lens[p])] for p in range(nproc)]
    return sharded.merge_segments(
        segments, vol_shape, block, glob_mulfac, use_local_rms
    )


def merge_segment_files(paths, vol_shape, block, scale=None,
                        use_local_rms=False):
    """Merge per-host segment files into one container.

    The shared glob_mulfac is read back from the first segment's header;
    every other segment's header must agree (same mulfac, block dims, and
    RMS mode) or the merge is rejected — segments compressed at different
    scales would otherwise merge silently into a corrupt container.
    """
    from .. import container as ctn

    segments = [np.fromfile(p, dtype=np.uint8) for p in paths]
    hdr, _, _, _ = ctn.unpack(segments[0])
    for p, seg in zip(paths[1:], segments[1:]):
        h = ctn.unpack(seg)[0]
        same = (
            h.glob_mulfac.view(np.uint32) == hdr.glob_mulfac.view(np.uint32)
            and (h.bx, h.by, h.bz) == (hdr.bx, hdr.by, hdr.bz)
            and h.use_local_rms == hdr.use_local_rms
        )
        if not same:
            raise ValueError(
                f"segment {p} header mismatch: mulfac/block/RMS-mode differ "
                f"from {paths[0]}"
            )
    return sharded.merge_segments(
        segments, vol_shape, block, hdr.glob_mulfac, use_local_rms
    )
