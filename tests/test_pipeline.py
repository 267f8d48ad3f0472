"""Streaming pipeline: ordering, parity with single-shot calls."""

import numpy as np

import cvxcompress_tpu as cvx
from cvxcompress_tpu import pipeline
from conftest import make_radial_volume


def test_compress_stream_order_and_parity():
    vols = [make_radial_volume(16, 16, 32, seed=s) for s in range(5)]
    singles = [cvx.compress(v, 1e-2, block=(16, 16, 16)) for v in vols]
    streamed = list(
        pipeline.compress_stream(vols, 1e-2, block=(16, 16, 16), workers=3)
    )
    assert len(streamed) == 5
    for (d1, r1), (d2, r2) in zip(singles, streamed):
        np.testing.assert_array_equal(d1, d2)
        assert r1 == r2


def test_compress_stream_bounded_lookahead():
    """The stream pulls lazily: at most workers+1 volumes in flight, so an
    unbounded snapshot stream never accumulates in memory."""
    pulled = []

    def gen():
        for s in range(8):
            pulled.append(s)
            yield make_radial_volume(16, 16, 32, seed=s)

    it = pipeline.compress_stream(gen(), 1e-2, block=(16, 16, 16), workers=2)
    first = next(it)
    assert first[0].size > 0
    # window = workers+1 = 3; after one yield at most 4 items were pulled
    assert len(pulled) <= 4
    rest = list(it)
    assert len(rest) == 7 and len(pulled) == 8


def test_decompress_stream_order():
    vols = [make_radial_volume(16, 16, 32, seed=s) for s in range(4)]
    datas = [cvx.compress(v, 1e-2, block=(16, 16, 16))[0] for v in vols]
    outs = list(pipeline.decompress_stream(datas, workers=2))
    for v, o in zip(vols, outs):
        assert np.abs(o - v).max() < 1e-1
