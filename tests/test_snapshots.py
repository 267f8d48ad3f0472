"""Device-resident snapshot stack: quality, memory accounting, LIFO use."""

import numpy as np
import pytest

from cvxcompress_tpu.snapshots import DeviceSnapshotStack
from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr


def test_snapshot_roundtrip_quality():
    shape = (64, 32, 32)
    store = DeviceSnapshotStack(shape, 1e-2, block=(32, 32, 32))
    vol = make_sinusoid_volume(*shape, periods=3)
    i = store.append(vol)
    out = np.asarray(store.get(i))
    err, snr = rel_error_and_snr(vol, out)
    assert err < 2e-4 and snr > 75.0
    assert store.ratio() > 5.0  # tiny volume; invmap overhead dominates


def test_snapshot_matches_codec_quality():
    # same transform + quantizer as the byte-stream codec -> same output
    import cvxcompress_tpu as cvx

    vol = make_radial_volume(nz=16, ny=32, nx=32)
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=(16, 16, 16))
    store.append(vol)
    snap = np.asarray(store.get(0))
    data, _ = cvx.compress(vol, 1e-2, block=(16, 16, 16))
    codec = cvx.decompress(data)
    # mulfac differs only by f32-vs-f64 RMS accumulation; outputs agree to
    # quantizer-step precision
    err = np.abs(snap - codec).max()
    assert err < 5e-2 * np.abs(vol).max(), err


def test_snapshot_stack_lifo():
    shape = (32, 16, 16)
    store = DeviceSnapshotStack(shape, 1e-2, block=(16, 16, 16))
    vols = [make_radial_volume(*shape, seed=s) for s in range(4)]
    for v in vols:
        store.append(v)
    assert len(store) == 4
    assert store.nbytes() > 0
    for v in reversed(vols):
        out = np.asarray(store.pop())
        err, _ = rel_error_and_snr(v, out)
        assert err < 2e-2
    assert len(store) == 0


def test_snapshot_all_zero():
    shape = (16, 16, 16)
    store = DeviceSnapshotStack(shape, 1e-2, block=(16, 16, 16))
    store.append(np.zeros(shape, np.float32))
    out = np.asarray(store.get(0))
    np.testing.assert_array_equal(out, 0.0)


def test_snapshot_to_container_bit_exact():
    """Decoding to_container's output reproduces get(i) bit-for-bit (the
    stored scaled integers re-encode losslessly)."""
    import cvxcompress_tpu as cvx

    vol = make_radial_volume(nz=32, ny=32, nx=32)
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=(16, 16, 16))
    i = store.append(vol)
    snap = np.asarray(store.get(i))
    data = store.to_container(i)
    out = cvx.decompress(data)
    np.testing.assert_array_equal(
        snap.view(np.uint32), out.view(np.uint32)
    )
    # other backends use the scalar inverse wavelet: same 1e-5-relative
    # contract the reference holds between its own fast/slow paths
    out_o = cvx.decompress(data, backend="oracle")
    denom = np.sqrt(np.mean(snap.astype(np.float64) ** 2)) + 1e-30
    rel = np.sqrt(np.mean((out_o - snap).astype(np.float64) ** 2)) / denom
    assert rel < 1e-5, rel


def test_snapshot_from_container_bit_exact():
    """from_container(compress(vol)) reconstructs exactly what
    decompress(container) yields."""
    import cvxcompress_tpu as cvx

    vol = make_radial_volume(nz=32, ny=32, nx=32)
    data, _ = cvx.compress(vol, 1e-2, block=(16, 16, 16))
    ref = cvx.decompress(data)
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=(16, 16, 16))
    i = store.from_container(data)
    snap = np.asarray(store.get(i))
    np.testing.assert_array_equal(snap.view(np.uint32), ref.view(np.uint32))


def test_snapshot_from_container_raw_blocks(rng):
    """Containers with raw-fallback blocks ingest correctly: raw payloads
    (unscaled coefficients, CvxCompress.cpp:552-555) are re-scaled into
    the fiv representation, so get() matches decompress(data) to f32
    rounding instead of being off by a factor of mulfac."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu import container as ctn

    # half the volume incompressible noise (raw blocks), half smooth
    vol = make_radial_volume(nz=32, ny=16, nx=16)
    vol[:16] = (rng.standard_normal((16, 16, 16)) * 1e10).astype(np.float32)
    data, _ = cvx.compress(vol, 1e-8, block=(16, 16, 16))
    _, blkoffs, _, _ = ctn.unpack(data)
    assert (np.asarray(blkoffs) < 0).any(), "fixture must contain raw blocks"
    assert not (np.asarray(blkoffs) < 0).all(), "fixture must mix raw/rle"
    ref = cvx.decompress(data)
    store = DeviceSnapshotStack(vol.shape, 1e-8, block=(16, 16, 16))
    i = store.from_container(data)
    snap = np.asarray(store.get(i))
    denom = np.abs(ref) + np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    rel = np.abs(snap - ref) / denom
    assert rel.max() < 1e-5, rel.max()  # ~1-2 ulp of the re-scale round trip


def test_snapshot_append_vs_codec_quantization_step():
    """The stack's device-f32 RMS can differ from the
    codec's host-f64 RMS by ~1 ulp, so append() and compress() may
    quantize differently — but only ever by ONE quantization step per
    coefficient.  Asserted at the scaled-integer (fiv) level."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu import container as ctn
    from cvxcompress_tpu.ops import codec as _codec

    vol = make_radial_volume(nz=32, ny=32, nx=32)
    block, chunk_shape = (16, 16, 16), None
    data, _ = cvx.compress(vol, 1e-2, block=block)
    hdr, blkoffs, _, pbase = ctn.unpack(data)
    # decode the codec's quantized integers (mulfac'=1.0 -> float(iv))
    iv_codec = _codec._decode_payloads_host(
        data,
        ctn.Header(hdr.nx, hdr.ny, hdr.nz, hdr.bx, hdr.by, hdr.bz,
                   np.float32(1.0), False),
        blkoffs, None, pbase,
    )
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=block)
    i = store.append(vol)
    fiv_stack = store.dense_fiv(i).reshape(iv_codec.shape)
    assert np.abs(fiv_stack - iv_codec).max() <= 1.0


def test_snapshot_container_roundtrip_chain():
    """stack -> container -> fresh stack -> identical reconstruction."""
    vol = make_sinusoid_volume(32, 32, 32, periods=3)
    s1 = DeviceSnapshotStack(vol.shape, 1e-2, block=(32, 32, 32))
    s1.append(vol)
    data = s1.to_container(0)
    s2 = DeviceSnapshotStack(vol.shape, 1e-2, block=(32, 32, 32))
    s2.from_container(data)
    a = np.asarray(s1.get(0))
    b = np.asarray(s2.get(0))
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_snapshot_chunk_mode_geometry():
    """bx=128 geometries (once a separate chunk-sparse representation) use
    the same plane rows; both container directions still hold."""
    import cvxcompress_tpu as cvx

    vol = make_radial_volume(nz=16, ny=8, nx=128)
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=(128, 8, 8))
    i = store.append(vol)
    out = np.asarray(store.get(i))
    err, _ = rel_error_and_snr(vol, out)
    assert err < 2e-2
    data = store.to_container(i)
    j = store.from_container(data)
    np.testing.assert_array_equal(
        np.asarray(store.get(j)).view(np.uint32),
        np.asarray(cvx.decompress(data)).view(np.uint32),
    )


@pytest.mark.parametrize(
    "shape,block",
    [
        ((16, 16, 40), (8, 8, 8)),        # bx = 8, partial x block
        ((32, 16, 64), (16, 16, 16)),
        ((64, 40, 96), (32, 32, 32)),     # partial y block
        ((16, 16, 192), (64, 16, 16)),    # bx = 64, partial x block
        ((8, 8, 256), (256, 8, 8)),       # bx = 256
        ((1, 32, 48), (16, 16, 1)),       # 2D (bz == 1)
    ],
)
def test_snapshot_geometries_match_decompress(shape, block):
    """One representation for every legal geometry: get(i) equals the
    byte-stream decode of to_container(i) bit for bit, and reconstructs
    the volume to quantizer precision."""
    import cvxcompress_tpu as cvx

    vol = make_radial_volume(*shape)
    store = DeviceSnapshotStack(vol.shape, 1e-2, block=block)
    i = store.append(vol)
    snap = np.asarray(store.get(i))
    assert snap.shape == vol.shape
    err, _ = rel_error_and_snr(vol, snap)
    assert err < 2e-2, err
    out = np.asarray(cvx.decompress(store.to_container(i)))
    np.testing.assert_array_equal(snap.view(np.uint32), out.view(np.uint32))


def test_snapshot_pending_bounded():
    """Appends retain at most max_pending dense intermediates."""
    shape = (16, 16, 16)
    store = DeviceSnapshotStack(shape, 1e-2, block=(16, 16, 16),
                                max_pending=2)
    for s in range(6):
        store.append(make_radial_volume(*shape, seed=s))
    assert len(store._pending) <= 2
    store.flush()
    assert not store._pending
    for i in range(6):
        assert store._snaps[i][3] is not None  # validated


def test_snapshot_capacity_overflow_retry():
    """A later snapshot with more active chunks than the speculative bucket
    triggers the deferred re-sparsify (validation path)."""
    shape = (32, 32, 32)
    store = DeviceSnapshotStack(shape, 1e-2, block=(16, 16, 16),
                                max_pending=1)
    sparse = np.zeros(shape, np.float32)
    sparse[0, 0, 0] = 1.0  # tiny active set -> small first bucket
    store.append(sparse)
    dense = make_radial_volume(*shape)  # much larger active set
    store.append(dense)
    store.flush()
    out0 = np.asarray(store.get(0))
    out1 = np.asarray(store.get(1))
    err1, _ = rel_error_and_snr(dense, out1)
    assert err1 < 2e-2, err1
    assert abs(out0[0, 0, 0] - 1.0) < 1e-2
    assert np.abs(out0.ravel()[1:]).max() < 1e-2
