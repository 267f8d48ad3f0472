"""Batched stream APIs: compress_many / decompress_many parity.

The batched paths exist to amortize per-volume host round trips (one d2h
fetch per compress batch, one h2d + one device program per decompress
batch).  Contract: containers are BYTE-IDENTICAL to per-volume
compress(); the decoded COEFFICIENT plane is BIT-IDENTICAL to the
per-volume decode; the final volumes agree within the transform contract
(the y/z inverse contractions run at a different batch shape, so f32
accumulation may differ in the last ulp — the same 1e-5 bar the
reference holds between its own slow and fast paths,
CvxCompress.cpp:597).  Covers local-RMS mode, raw fallback blocks
(offset block ids in the stacked decode), unpadded z, and the
mixed-geometry fallback.
"""

import jax
import numpy as np
import pytest

from cvxcompress_tpu import pipeline
from cvxcompress_tpu.ops import codec as jcodec

F32 = np.float32


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _vols(rng, k=3, shape=(16, 16, 16)):
    return [
        (np.sin(np.arange(np.prod(shape), dtype=F32) / (7.0 + j))
         .reshape(shape) + rng.standard_normal(shape).astype(F32) * 0.01)
        .astype(F32)
        for j in range(k)
    ]


def _assert_volumes_match(singles, batched):
    """Per-volume vs batched decode: equal within the last-ulp inverse
    contract (most elements bit-equal; rel RMS < 1e-6)."""
    assert batched is not None and len(batched) == len(singles)
    for o1, o2 in zip(singles, batched):
        a = np.asarray(o1, np.float64)
        b = np.asarray(o2, np.float64)
        denom = np.sqrt((a * a).mean()) or 1.0
        rel = np.sqrt(((a - b) ** 2).mean()) / denom
        assert rel < 1e-6, f"rel RMS {rel}"


def test_compress_many_container_parity(rng):
    vols = _vols(rng)
    singles = [jcodec.compress(v, 1e-2, block=(8, 8, 8)) for v in vols]
    batched = jcodec.compress_many(vols, 1e-2, block=(8, 8, 8))
    assert len(batched) == len(singles)
    for (d1, r1), (d2, r2) in zip(singles, batched):
        np.testing.assert_array_equal(d1, d2)
        assert r1 == r2


def test_compress_many_device_inputs(rng):
    """Device-resident volumes: the Σx² fetches batch; containers match
    the per-volume device-input path bit for bit."""
    vols = _vols(rng)
    dev = [jax.device_put(v) for v in vols]
    singles = [jcodec.compress(v, 1e-2, block=(8, 8, 8)) for v in dev]
    batched = jcodec.compress_many(dev, 1e-2, block=(8, 8, 8))
    for (d1, _), (d2, _) in zip(singles, batched):
        np.testing.assert_array_equal(d1, d2)


def test_compress_many_local_rms(rng):
    vols = _vols(rng)
    singles = [
        jcodec.compress(v, 1e-2, block=(8, 8, 8), use_local_rms=True)
        for v in vols
    ]
    batched = jcodec.compress_many(
        vols, 1e-2, block=(8, 8, 8), use_local_rms=True
    )
    for (d1, _), (d2, _) in zip(singles, batched):
        np.testing.assert_array_equal(d1, d2)


def test_decompress_many_parity(rng):
    vols = _vols(rng, k=4, shape=(24, 16, 16))
    datas = [jcodec.compress(v, 1e-2, block=(8, 8, 8))[0] for v in vols]
    singles = [jcodec.decompress(d) for d in datas]
    batched = jcodec.decompress_many(datas)
    _assert_volumes_match(singles, batched)


def test_decompress_many_local_rms(rng):
    vols = _vols(rng, k=3)
    datas = [
        jcodec.compress(v, 1e-2, block=(8, 8, 8), use_local_rms=True)[0]
        for v in vols
    ]
    singles = [jcodec.decompress(d) for d in datas]
    batched = jcodec.decompress_many(datas)
    _assert_volumes_match(singles, batched)


def test_decompress_many_raw_blocks(rng):
    """A batch mixing compressible volumes with one whose blocks all take
    the raw fallback: the stacked decode must overlay raw payloads at the
    OFFSET block ids."""
    good = _vols(rng, k=2)
    bad = (rng.standard_normal((16, 16, 16)) * 1e10).astype(F32)
    vols = [good[0], bad, good[1]]
    datas = [jcodec.compress(v, 1e-8, block=(8, 8, 8))[0] for v in vols]
    singles = [jcodec.decompress(d) for d in datas]
    batched = jcodec.decompress_many(datas)
    _assert_volumes_match(singles, batched)


def test_decompress_many_unpadded_z(rng):
    """nz not a multiple of bz: the stacked pseudo-volume spaces volumes
    at the PADDED z pitch and the split slices each back to nz."""
    vols = _vols(rng, k=3, shape=(20, 16, 16))  # nz=20, bz=8 -> nzp=24
    datas = [jcodec.compress(v, 1e-2, block=(8, 8, 8))[0] for v in vols]
    singles = [jcodec.decompress(d) for d in datas]
    batched = jcodec.decompress_many(datas)
    _assert_volumes_match(singles, batched)


def test_plan_row_decode_plane_bit_exact(rng):
    """The batched plan-row decode's COEFFICIENT plane is bit-identical
    to the per-volume decodes: the row unbundle, parse, scatter targets,
    and dequantization are exact integer/float math, and the inert
    padding segments (reset=True, discard block) contribute nothing."""
    import jax.numpy as jnp

    from cvxcompress_tpu.ops import entropy_decode as ed

    shape, block = (24, 16, 16), (8, 8, 8)
    vols = _vols(rng, k=3, shape=shape)
    datas = [jcodec.compress(v, 1e-2, block=block)[0] for v in vols]
    planes = []
    for d in datas:
        p = ed.plan(d)
        segs, sb, sr, sf = jcodec._upload_plan(p)
        pl = ed.decode_to_volume(
            segs, sb, sr, sf, shape, block, p["segs"].shape[0]
        )
        planes.append(np.asarray(pl))
    plans = [ed.plan(d, reuse_staging=False) for d in datas]
    hdr = plans[0]["hdr"]
    need = max(p["segs"].shape[0] for p in plans)
    cap = need + 3  # deliberately unpadded-odd cap: padding must be inert
    blob = jnp.asarray(jcodec._plan_rows(plans, cap, hdr.grid[3], False))
    for k, pl in enumerate(planes):
        got = np.asarray(jcodec._decode_plane_row(
            blob[k], shape, block, cap, False
        ))
        np.testing.assert_array_equal(got, pl)


def test_decompress_batched_mixed_geometry_falls_back(rng):
    v1 = _vols(rng, k=1, shape=(16, 16, 16))[0]
    v2 = _vols(rng, k=1, shape=(24, 16, 16))[0]
    d1, _ = jcodec.compress(v1, 1e-2, block=(8, 8, 8))
    d2, _ = jcodec.compress(v2, 1e-2, block=(8, 8, 8))
    assert jcodec.decompress_many([d1, d2]) is None
    outs = pipeline.decompress_batched([d1, d2])
    np.testing.assert_array_equal(outs[0], jcodec.decompress(d1))
    np.testing.assert_array_equal(outs[1], jcodec.decompress(d2))


def test_batched_stream_generators(rng):
    vols = _vols(rng, k=5)
    ref = [jcodec.compress(v, 1e-2, block=(8, 8, 8)) for v in vols]
    got = list(pipeline.compress_stream_batched(
        iter(vols), 1e-2, block=(8, 8, 8), batch=2
    ))
    assert len(got) == 5
    for (d1, _), (d2, _) in zip(ref, got):
        np.testing.assert_array_equal(d1, d2)
    outs = list(pipeline.decompress_stream_batched(
        (d for d, _ in got), batch=2
    ))
    _assert_volumes_match([jcodec.decompress(d) for d, _ in ref], outs)


def test_edge_cases(rng):
    assert jcodec.compress_many([], 1e-2) == []
    assert jcodec.decompress_many([]) == []
    v = _vols(rng, k=1)[0]
    (d1, r1), = jcodec.compress_many([v], 1e-2, block=(8, 8, 8))
    d2, r2 = jcodec.compress(v, 1e-2, block=(8, 8, 8))
    np.testing.assert_array_equal(d1, d2)
    out, = jcodec.decompress_many([d1])
    np.testing.assert_array_equal(out, jcodec.decompress(d1))  # k=1: same program
