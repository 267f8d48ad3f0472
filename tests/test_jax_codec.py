"""End-to-end device codec: round trips, cross-backend compatibility."""

import numpy as np
import pytest

import cvxcompress_tpu as cvx
from cvxcompress_tpu import container as ctn
from cvxcompress_tpu.oracle import codec as ocodec
from cvxcompress_tpu.oracle import rle as orle
from cvxcompress_tpu.ops import codec as jcodec

from conftest import make_radial_volume, make_sinusoid_volume, rel_error_and_snr

F32 = np.float32


def test_roundtrip_sinusoid_quality_bars():
    vol = make_sinusoid_volume(96, 64, 64, periods=3)
    data, ratio = jcodec.compress(vol, 1e-2, block=(32, 32, 32))
    out = jcodec.decompress(data)
    err, snr = rel_error_and_snr(vol, out)
    assert err < 2e-4, err
    assert snr > 75.0, snr
    assert ratio > 500.0


def test_roundtrip_radial_partial_blocks():
    vol = make_radial_volume(nz=19, ny=27, nx=41)
    data, ratio = jcodec.compress(vol, 1e-2, block=(16, 16, 16))
    out = jcodec.decompress(data)
    err, _ = rel_error_and_snr(vol, out)
    assert err < 1e-2
    # quantizer correctness: error shrinks with scale
    data2, _ = jcodec.compress(vol, 1e-4, block=(16, 16, 16))
    err2, _ = rel_error_and_snr(vol, jcodec.decompress(data2))
    assert err2 < err / 10


@pytest.mark.parametrize(
    "shape,block",
    [
        ((96, 64, 64), (32, 32, 32)),
        ((19, 27, 41), (16, 16, 16)),
        ((64, 64, 128), (128, 64, 32)),
        ((1, 32, 32), (16, 16, 1)),
        ((40, 24, 24), (8, 8, 8)),
    ],
)
def test_volume_order_decompress_matches_blockmajor(shape, block, rng):
    """The relayout-free decompress path agrees with the legacy block-major
    expand+inverse+unlayout to the cross-shape matmul tolerance."""
    import jax.numpy as jnp

    from cvxcompress_tpu.ops import rle_device

    vol = rng.standard_normal(shape).astype(np.float32)
    data, _ = jcodec.compress(vol, 1e-3, block=block)
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    cells = block[0] * block[1] * block[2]
    chunk = rle_device.chunk_cells(cells)
    coeffs = jcodec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)
    pay, inv, _ = jcodec.sparse_chunks(coeffs, cells, chunk)
    a = np.asarray(jcodec._decompress_sparse(
        jnp.asarray(pay), jnp.asarray(inv), shape, block, chunk))
    b = np.asarray(jcodec._decompress_sparse_blockmajor(
        jnp.asarray(pay), jnp.asarray(inv), shape, block, chunk))
    denom = np.sqrt(np.mean(b.astype(np.float64) ** 2)) + 1e-30
    rel = np.sqrt(np.mean((a - b).astype(np.float64) ** 2)) / denom
    assert rel < 1e-6, rel


def test_cross_backend_decode():
    # jax-compressed containers decode with the oracle backend and vice versa
    vol = make_radial_volume(nz=16, ny=24, nx=32)
    dj, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    do, _ = ocodec.compress(vol, 1e-2, block=(8, 8, 8))
    outs = [
        ocodec.decompress(dj),
        jcodec.decompress(dj),
        ocodec.decompress(do),
        jcodec.decompress(do),
    ]
    for o in outs:
        err, _ = rel_error_and_snr(vol, o)
        assert err < 1e-2
    # decoding the SAME container must agree bitwise across backends
    # (identical entropy decode; identical-to-1e-5 inverse transforms would
    # differ bitwise, so compare payload-level decode instead below)
    np.testing.assert_allclose(outs[0], outs[1], atol=2e-5 * np.abs(vol).max())


def test_container_bit_equality_same_coefficients():
    # downstream of the transform, the two backends are bit-identical:
    # feed the SAME coefficients through both entropy stages
    import jax.numpy as jnp

    from cvxcompress_tpu.ops import rle_device, wavelet

    r = np.random.default_rng(5)
    blocks = r.standard_normal((6, 8, 8, 8)).astype(F32)
    coeffs = np.asarray(wavelet.forward_3d(jnp.asarray(blocks)))
    mf = F32(0.37)
    flat = coeffs.reshape(6, -1)
    cells = flat.shape[1]
    chunk = rle_device.chunk_cells(cells)
    fv = jnp.asarray((flat * mf).astype(F32))
    desc, chunk_bytes, sizes, raw, counts = rle_device.tokenize_desc(
        rle_device.as_rows(fv), 6, chunk
    )
    cchunks = fv.reshape(-1, chunk)
    cb_h, sizes_h, raw_h = map(np.asarray, (chunk_bytes, sizes, raw))
    acap, lcap = rle_device.plan_capacities(cb_h)
    subrows = np.asarray(
        rle_device.pack_active(cchunks, desc, chunk_bytes, acap, lcap)[0]
    )
    stream, total = rle_device.assemble_payload(
        subrows, cb_h, sizes_h, raw_h, None, cells, chunk
    )
    pos = 0
    for i in range(6):
        expect = orle.encode(mf, flat[i])
        got = stream[pos : pos + sizes_h[i]].tobytes()
        assert got == expect, f"block {i} differs"
        pos += sizes_h[i]


def test_local_rms_roundtrip():
    vol = make_radial_volume(nz=16, ny=16, nx=16)
    data, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8), use_local_rms=True)
    hdr, _, blkmf, _ = ctn.unpack(data)
    assert hdr.use_local_rms and blkmf is not None and np.all(blkmf > 0)
    out = jcodec.decompress(data)
    err, _ = rel_error_and_snr(vol, out)
    assert err < 1e-2


def test_2d_volume():
    vol = make_radial_volume(nz=1, ny=32, nx=32)
    data, _ = jcodec.compress(vol, 1e-2, block=(16, 16, 1))
    out = jcodec.decompress(data)
    err, _ = rel_error_and_snr(vol, out)
    assert err < 1e-2


def test_public_api_jax_backend():
    vol = make_sinusoid_volume(64, 32, 32, periods=2)
    data, ratio = cvx.compress(vol, 1e-2, block=(32, 32, 32), backend="jax")
    out = cvx.decompress(data, backend="jax")
    err, snr = rel_error_and_snr(vol, out)
    assert err < 2e-4 and snr > 75.0


def test_compressed_size_close_to_oracle():
    # transforms differ at ~1e-6 so sizes can differ slightly at quantization
    # boundaries; they must stay within a fraction of a percent
    vol = make_radial_volume(nz=16, ny=24, nx=32)
    dj, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    do, _ = ocodec.compress(vol, 1e-2, block=(8, 8, 8))
    assert abs(int(dj.size) - int(do.size)) <= max(64, 0.01 * do.size)


@pytest.mark.parametrize(
    "vol_shape,block",
    [
        ((8, 8, 256), (256, 8, 8)),   # max block extent on the fast axis
        ((256, 8, 8), (8, 8, 256)),   # max extent on the slow axis
        ((64, 64, 64), (64, 64, 64)), # single big cubic block
        ((4, 128, 128), (128, 128, 1)),  # 2D blocks over a thin volume
    ],
)
def test_extreme_block_shapes(vol_shape, block):
    vol = make_radial_volume(*vol_shape)
    data, _ = jcodec.compress(vol, 1e-3, block=block)
    out = jcodec.decompress(data)
    err, _ = rel_error_and_snr(vol, out)
    assert err < 2e-3, (vol_shape, block, err)
    # cross-backend: oracle decodes the same container
    out2 = ocodec.decompress(data)
    err2, _ = rel_error_and_snr(vol, out2)
    assert err2 < 2e-3


def test_all_raw_volume_roundtrip(rng):
    """A volume where every block takes the raw fallback reconstructs the
    coefficients bit-exactly (raw payload bytes are the untouched f32s)."""
    vol = (rng.standard_normal((16, 16, 16)) * 1e10).astype(F32)
    data, ratio = jcodec.compress(vol, 1e-8, block=(8, 8, 8))
    hdr, blkoffs, _, _ = ctn.unpack(data)
    assert (blkoffs < 0).all(), "expected every block raw"
    assert ratio < 1.1  # raw storage + tables: no compression
    out = jcodec.decompress(data)
    err, _ = rel_error_and_snr(vol, out)
    assert err < 1e-5  # only transform forward+inverse error remains


def test_noncontiguous_and_f64_inputs():
    vol = make_radial_volume(nz=16, ny=16, nx=32)
    strided = vol[::1, ::1, ::2]  # non-contiguous view
    d1, _ = jcodec.compress(np.ascontiguousarray(strided), 1e-2, block=(8, 8, 8))
    d2, _ = jcodec.compress(strided, 1e-2, block=(8, 8, 8))
    np.testing.assert_array_equal(d1, d2)
    d3, _ = jcodec.compress(strided.astype(np.float64), 1e-2, block=(8, 8, 8))
    np.testing.assert_array_equal(d1, d3)


@pytest.mark.parametrize(
    "shape,block,density,scale",
    [
        ((64, 96, 96), (32, 32, 32), 0.15, 30.0),   # mixed classes, sparse
        ((64, 96, 96), (32, 32, 32), 0.9, 2000.0),  # dense + raw blocks
        ((64, 64, 160), (16, 32, 32), 0.2, 30.0),   # bx=16, partial x block
        ((32, 64, 96), (8, 16, 32), 0.3, 30.0),     # bx=8
        ((64, 64, 192), (64, 32, 64), 0.25, 30.0),  # bx=64
    ],
)
def test_container_matches_oracle_random(rng, shape, block, density, scale):
    """Every block's payload equals the oracle encoder fed the device's own
    scaled coefficients, on adversarial random data: every token class
    (incl. VLESC4 raw floats), zero runs straddling chunks and rows, and
    raw-fallback blocks; the device parse and the host decoder agree."""
    from cvxcompress_tpu.utils import checks

    vol = (rng.standard_normal(shape) * scale).astype(np.float32)
    vol[rng.random(shape) >= density] = 0.0
    # a handful of huge values to force VLESC4 / int-range edge tokens
    flat = vol.reshape(-1)
    hot = rng.integers(0, flat.size, 50)
    flat[hot] = (rng.standard_normal(50) * 3e9).astype(np.float32)

    data, _ = jcodec.compress(vol, 1e-2, block=block)
    ids = np.arange(ctn.unpack(data)[0].grid[3])
    assert checks.entropy_mismatches(vol, data, 1e-2, ids) == []
    assert checks.decoders_agree(data)


def test_local_rms_container_matches_oracle():
    """Local RMS: per-block mulfacs equal the device's own, every payload
    equals the oracle encoder's, and the round trip holds the codec's
    quality on the CI-style sinusoid."""
    from cvxcompress_tpu.utils import checks

    shape, block = (64, 96, 96), (32, 32, 32)
    vol = make_sinusoid_volume(*shape, periods=3)
    data, _ = jcodec.compress(vol, 1e-2, block=block, use_local_rms=True)
    hdr, _, mfs, _ = ctn.unpack(data)
    assert hdr.use_local_rms and np.all(mfs > 0)
    ids = np.arange(hdr.grid[3])
    assert checks.entropy_mismatches(vol, data, 1e-2, ids) == []
    out = jcodec.decompress(data)
    assert checks.roundtrip_error(data, out, ids) < 1e-5
    err, _ = rel_error_and_snr(vol, out)
    assert err < 2e-2


def test_random_volume_quality(rng):
    """Random sparse data decodes as well as the oracle codec's own
    container (per-cell decode error is NOT bounded by one quantization
    step — inverse-wavelet synthesis gain amplifies the coefficient
    rounding — so compare rel-RMS error), and the oracle backend decodes
    the device container to the transform contract."""
    shape, block = (64, 64, 160), (16, 32, 32)
    vol = (rng.standard_normal(shape) * 50).astype(np.float32)
    vol[rng.random(shape) >= 0.2] = 0.0
    data, _ = jcodec.compress(vol, 1e-2, block=block)
    out = jcodec.decompress(data)
    ref, _ = ocodec.compress(vol, 1e-2, block=block)
    base = ocodec.decompress(ref)
    rel = np.sqrt(np.mean((out - vol) ** 2)) / np.sqrt(np.mean(vol**2))
    rel_base = np.sqrt(np.mean((base - vol) ** 2)) / np.sqrt(np.mean(vol**2))
    assert rel <= rel_base * 1.05 + 1e-12
    out2 = ocodec.decompress(data)  # scalar oracle inverse vs device
    assert np.abs(out2 - out).max() <= 1e-4 * np.abs(out).max()


def test_caps_cache_overflow_repacks(rng):
    """A stream whose content jumps (low-entropy volume seeds small
    cached caps, then a dense volume overflows them) must repack with
    exact caps and still emit byte-identical containers to the
    cache-free standard path."""
    shape, block = (64, 96, 96), (32, 32, 32)

    quiet = make_sinusoid_volume(*shape, periods=2) * 1e-3
    dense = (rng.standard_normal(shape) * 500).astype(np.float32)

    # cache-free references: exact caps from the counts readback
    jcodec._CAPS_CACHE.clear()
    ref_d, _ = jcodec.compress(dense, 1e-2, block=block)
    jcodec._CAPS_CACHE.clear()
    ref_q, _ = jcodec.compress(quiet, 1e-2, block=block)

    # stream: quiet seeds tiny cached caps, dense MUST overflow + repack
    jcodec._CAPS_CACHE.clear()
    d_q, _ = jcodec.compress(quiet, 1e-2, block=block)
    d_d, _ = jcodec.compress(dense, 1e-2, block=block)
    d_q2, _ = jcodec.compress(quiet, 1e-2, block=block)  # shrinks again

    np.testing.assert_array_equal(np.asarray(ref_q), np.asarray(d_q))
    np.testing.assert_array_equal(np.asarray(ref_d), np.asarray(d_d))
    np.testing.assert_array_equal(np.asarray(ref_q), np.asarray(d_q2))


def test_platform_is_read_from_the_compute_devices():
    """The codec's one platform decision comes from jax.devices() — the
    devices its jits run on — and is read once per process."""
    import jax

    assert jcodec.platform() == jax.devices()[0].platform == "cpu"
    hits = jcodec.platform.cache_info().hits
    jcodec.platform()
    assert jcodec.platform.cache_info().hits == hits + 1


@pytest.mark.parametrize(
    "platform,engine",
    [("cpu", "host"), ("gpu", jcodec.AUTO_ENGINE["gpu"]), ("rocm", "host")],
)
def test_auto_engine_rule(monkeypatch, platform, engine):
    """auto takes the engine measured faster on the platform (the table),
    and the host engine on every platform the table does not name."""
    monkeypatch.setattr(jcodec, "platform", lambda: platform)
    assert jcodec.auto_engine() == engine


@pytest.mark.parametrize("engine", ["device", "host"])
def test_decompress_auto_runs_the_rule_engine(monkeypatch, engine):
    vol = make_sinusoid_volume(32, 32, 32, periods=2)
    data, _ = jcodec.compress(vol, 1e-2, block=(16, 16, 16))
    ran = []
    real = jcodec.decompress_device

    def spy(d, to_host=True):
        ran.append("device")
        return real(d, to_host)

    monkeypatch.setattr(jcodec, "decompress_device", spy)
    monkeypatch.setattr(jcodec, "auto_engine", lambda: engine)
    out = jcodec.decompress(data)
    assert ran == (["device"] if engine == "device" else [])
    np.testing.assert_array_equal(out, jcodec.decompress(data, engine=engine))


def test_decompress_unknown_engine_rejected():
    vol = make_sinusoid_volume(16, 16, 16, periods=2)
    data, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    with pytest.raises(ValueError, match="unknown engine"):
        jcodec.decompress(data, engine="gpu")


@pytest.mark.parametrize(
    "shape,block,scale",
    [
        ((96, 64, 64), (32, 32, 32), 1e-2),
        ((19, 27, 41), (16, 16, 16), 1e-2),   # partial edge blocks
        ((64, 64, 128), (128, 64, 32), 1e-3),  # bx = 128
        ((8, 8, 256), (256, 8, 8), 1e-3),      # bx = 256 (chunk < bx)
        ((1, 32, 32), (16, 16, 1), 1e-2),      # 2D (bz == 1)
    ],
)
def test_engines_bit_identical(rng, shape, block, scale):
    """Both decompress engines end in the same expand + inverse, so they
    give bit-identical volumes (the entropy decoders are bit-exact)."""
    vol = rng.standard_normal(shape).astype(np.float32)
    data, _ = jcodec.compress(vol, scale, block=block)
    a = jcodec.decompress(data, engine="device")
    b = jcodec.decompress(data, engine="host")
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
