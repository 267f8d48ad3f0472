"""Streaming / pipelined codec driver for snapshot sequences.

The production shape of this codec is RTM wavefield snapshot streams: one
volume per timestep, compressed on the fly (forward pass) and decompressed
in reverse order (backward pass).  The reference overlaps work with OpenMP
threads inside one volume; on the device the right overlap is ACROSS
volumes:

  * device work is dispatched asynchronously (jax dispatch returns in
    well under a millisecond; the device serializes execution),
  * the per-volume host work — capacity-count readback, compressed-bytes
    readback, container assembly — runs on a thread pool so the readback
    round trips of volume k overlap the device compute of volumes k+1..k+w.

`compress_stream` / `decompress_stream` preserve input order.  Throughput
scales until either the device (time per volume) or the host link
saturates.
"""

from __future__ import annotations

import collections
import concurrent.futures as _cf

from .ops import codec as _codec


def _windowed(ex, fn, items, window):
    """Submit at most `window` items ahead, yielding results in order.

    Pulls from `items` lazily so an unbounded stream (the RTM snapshot
    use case) holds at most `window` volumes in flight at any time.
    """
    items = iter(items)
    futs = collections.deque()
    try:
        while True:
            while len(futs) < window:
                try:
                    futs.append(ex.submit(fn, next(items)))
                except StopIteration:
                    break
            if not futs:
                return
            yield futs.popleft().result()
    finally:
        for f in futs:
            f.cancel()


def compress_stream(volumes, scale, block=(32, 32, 32), use_local_rms=False,
                    workers=6):
    """Compress an iterable of same-shape volumes, pipelined; yields
    (container, ratio) in input order.  At most workers+1 volumes are
    in flight (the input iterable is consumed lazily)."""
    with _cf.ThreadPoolExecutor(workers) as ex:
        yield from _windowed(
            ex,
            lambda v: _codec.compress(v, scale, block, use_local_rms),
            volumes,
            workers + 1,
        )


def decompress_stream(containers, workers=6):
    """Decompress an iterable of containers, pipelined; yields volumes in
    input order.  At most workers+1 containers are in flight."""
    with _cf.ThreadPoolExecutor(workers) as ex:
        yield from _windowed(ex, _codec.decompress, containers, workers + 1)


# ---------------------------------------------------------------------------
# Batched stream APIs: the per-volume host round trips (one d2h fetch per
# compress, one h2d + dispatch per decompress) are amortized K-fold by
# batching K volumes into ONE fetch / ONE upload.  These are the
# production entry points for RTM snapshot sequences.
# ---------------------------------------------------------------------------


def compress_batched(volumes, scale, block=(32, 32, 32),
                     use_local_rms=False, with_ratio=False,
                     glob_mulfacs=None):
    """Compress a batch of same-shape volumes with ONE bundled d2h fetch.

    Returns a list of containers (or (container, ratio) pairs when
    `with_ratio`).  Containers are byte-identical to per-volume
    compress().  Device-resident input volumes never leave HBM.

    `glob_mulfacs` (optional, one per volume) overrides the internally
    computed global quantization factors — the sharded/multi-host layer's
    contract (the global RMS is reduced across shards before any shard
    compresses).
    """
    res = _codec.compress_many(
        list(volumes), scale, block=block, use_local_rms=use_local_rms,
        glob_mulfacs=glob_mulfacs,
    )
    return res if with_ratio else [d for d, _ in res]


def decompress_batched(containers, to_host=True):
    """Decompress a batch of same-geometry containers in ONE device program.

    Returns volumes in input order (device arrays when `to_host=False` —
    the RTM backward-pass shape).  Falls back to per-container decompress
    for mixed geometries or degenerate containers.
    """
    containers = list(containers)
    out = _codec.decompress_many(containers, to_host=to_host)
    if out is None:
        out = [_codec.decompress(d) for d in containers]
    return out


def _batches(items, batch):
    buf = []
    for it in items:
        buf.append(it)
        if len(buf) == batch:
            yield buf
            buf = []
    if buf:
        yield buf


def compress_stream_batched(volumes, scale, block=(32, 32, 32),
                            use_local_rms=False, batch=4, lookahead=1,
                            glob_mulfacs=None):
    """Batched streaming compress: yields (container, ratio) in input
    order, consuming the volume stream `batch` at a time.

    `glob_mulfacs` (optional iterable, consumed in lockstep with
    `volumes`) overrides the per-volume global quantization factors —
    the sharded/multi-host layer's contract.

    DISPATCH-AHEAD pipelining: batch i+1's device pipelines dispatch
    BEFORE batch i's bundle fetch, so the d2h transfer and the host
    container assembly hide under the device's compute of the next batch.
    The bundle fetch itself runs on a dedicated TRANSFER THREAD: a d2h
    blocks its calling thread but releases the GIL, so the main thread
    keeps dispatching while the transfer lane drains.
    `lookahead` batches of small output bundles (not coefficient planes)
    stay alive.
    """
    import jax.numpy as jnp
    import numpy as np

    pending = collections.deque()
    if glob_mulfacs is None:
        import itertools

        paired = zip(volumes, itertools.repeat(None))
    else:
        paired = zip(volumes, glob_mulfacs)

    def stage(ex, chunk):
        vols = [_codec._prep_vol(v) for v, _ in chunk]
        mfs = [
            _codec._prep_mulfac(v, scale, use_local_rms, gmf)
            for v, (_, gmf) in zip(vols, chunk)
        ]
        ctxs = [
            _codec._compress_stage(v, scale, block, use_local_rms, m)
            for v, m in zip(vols, mfs)
        ]
        if len(ctxs) == 1:
            bundle = ctxs[0]["bundle"]
        else:
            bundle = jnp.concatenate([c["bundle"] for c in ctxs])
        return ctxs, ex.submit(np.asarray, bundle)  # fetch on the lane

    def finish(ctxs, fut):
        blob = fut.result()
        off = 0
        for c in ctxs:
            nb = c["nbytes"]
            yield _codec._compress_finish(c, blob[off:off + nb])
            off += nb

    with _cf.ThreadPoolExecutor(1) as ex:
        for chunk in _batches(paired, batch):
            pending.append(stage(ex, chunk))
            while len(pending) > lookahead:
                yield from finish(*pending.popleft())
        while pending:
            yield from finish(*pending.popleft())


def decompress_stream_batched(containers, batch=4, to_host=True,
                              lookahead=1):
    """Batched streaming decompress: yields volumes in input order.

    The host planning (container parse + plan-blob build) runs on the
    main thread; the transfers and program dispatch run on a dedicated
    TRANSFER THREAD (one h2d blob per batch blocks its caller but
    releases the GIL).  Batch i+1 plans while batch i uploads/decodes.
    """
    import numpy as np

    pending = collections.deque()

    def dispatch(prep, chunk):
        if prep is None:
            if len(chunk) == 1:
                out = _codec.decompress_device(chunk[0], to_host=False)
                vols = out[None] if out is not None else None
            else:
                vols = None
        else:
            vols = _codec._decompress_many_dispatch(prep)
        if vols is not None and to_host:
            return np.asarray(vols), True  # ONE fetch per batch
        return vols, False

    def finish(chunk, fut):
        vols, on_host = fut.result()
        if vols is None:  # degenerate/mixed: per-volume fallback
            for d in chunk:
                yield _codec.decompress(d)
            return
        for i in range(vols.shape[0]):
            yield vols[i]

    with _cf.ThreadPoolExecutor(1) as ex:
        for chunk in _batches(containers, batch):
            prep = (
                _codec._decompress_many_prepare(chunk) if len(chunk) > 1
                else None
            )
            pending.append((chunk, ex.submit(dispatch, prep, chunk)))
            while len(pending) > lookahead:
                yield from finish(*pending.popleft())
        while pending:
            yield from finish(*pending.popleft())
