"""Utils package: volumes, container IO, profiling models."""

import numpy as np
import pytest

import cvxcompress_tpu as cvx
from cvxcompress_tpu.utils import io as cio
from cvxcompress_tpu.utils import profiling as prof
from cvxcompress_tpu.utils import volumes


def test_raw_file_roundtrip(tmp_path):
    vol = volumes.radial_volume(9, 11, 13)
    p = tmp_path / "v.bin"
    volumes.write_raw(p, vol)
    back = volumes.read_raw(p, 9, 11, 13)
    np.testing.assert_array_equal(back, vol)
    with pytest.raises(ValueError):
        volumes.read_raw(p, 9, 11, 14)


def test_container_io_and_probe(tmp_path):
    vol = volumes.sinusoid_volume(32, 32, 32, periods=2)
    data, ratio = cvx.compress(vol, 1e-2, block=(16, 16, 16))
    p = tmp_path / "c.cvx"
    cio.save(p, data)
    back = cio.load(p)
    np.testing.assert_array_equal(back, data)
    info = cio.probe(back)
    assert info["shape_zyx"] == (32, 32, 32)
    assert info["block_xyz"] == (16, 16, 16)
    assert info["blocks"] == 8
    assert info["raw_blocks"] == 0
    assert abs(info["ratio"] - ratio) < 1e-6
    out = cvx.decompress(back)
    assert np.abs(out - vol).max() < 1e-1  # quantization-level at scale 1e-2


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "junk.cvx"
    np.arange(100, dtype=np.uint8).tofile(p)
    with pytest.raises(ValueError):
        cio.load(p)


def test_pattern_volume_exact():
    v = volumes.pattern_volume(3, 4, 5, seed=9)
    idx = v.view(np.uint32).ravel()
    np.testing.assert_array_equal(idx, np.arange(60, dtype=np.uint32) + 9)


def test_flop_models():
    # lifting model matches the reference sum for a known case:
    # dim 8: levels 8,4,2 -> 23*(4+2+1) = 161 flops / 8 cells
    assert abs(prof.lifting_flops_per_cell_1d(8) - 161.0 / 8) < 1e-12
    assert prof.matmul_flops_per_cell((32, 32, 32)) == 2 * 96
    assert prof.lifting_flops_per_cell((8, 8, 1)) == 2 * 161.0 / 8


def test_timer_reports():
    t = prof.Timer()
    with t.stage("x"):
        sum(range(1000))
    r = t.report("x", 1_000_000, flops_per_cell=2.0)
    assert r["mcells_s"] > 0 and r["gflop_s"] > 0


def test_container_fuzz_truncations(rng):
    """Truncated / bit-flipped containers raise, never crash or hang."""
    from cvxcompress_tpu import container as ctn

    vol = volumes.radial_volume(16, 16, 16)
    data, _ = cvx.compress(vol, 1e-2, block=(8, 8, 8))
    for cut in (0, 4, 16, 31, 33, data.size // 2):
        with pytest.raises(ValueError):
            ctn.unpack(data[:cut]) if cut < 32 else cio_load_checked(
                data[:cut]
            )


def cio_load_checked(data):
    """unpack + payload-extent sanity (same checks as utils.io.load)."""
    from cvxcompress_tpu.utils import io as uio

    return uio.validate(data)


def test_decompress_inplace_api():
    vol = volumes.radial_volume(16, 16, 16)
    data, _ = cvx.compress(vol, 1e-2, block=(8, 8, 8))
    out = np.empty_like(vol)
    cc = cvx.CvxCompress()
    cc.Decompress_Inplace(out, data)
    assert np.abs(out - vol).max() < 1e-1  # quantization-level at scale 1e-2
    with pytest.raises(ValueError):
        cc.Decompress_Inplace(np.empty((8, 8, 8), np.float32), data)


def test_decode_bounded_on_midpayload_truncation(rng):
    """A cut that keeps every offset in range but truncates a block's
    STREAM is caught by the buffer-bounded decoders (an earlier
    validate() passed such containers straight into C++)."""
    vol = rng.standard_normal((16, 16, 16)).astype(np.float32)
    data, _ = cvx.compress(vol, 1e-2, block=(8, 8, 8))
    cut = data[: data.size - 64]
    with pytest.raises(ValueError):
        cvx.decompress(cut, backend="jax")
    from cvxcompress_tpu.ops import rle_host

    if rle_host.available():
        with pytest.raises(ValueError):
            # drive the native batch decoder directly as well
            from cvxcompress_tpu import container as ctn

            hdr, blkoffs, _, pbase = ctn.unpack(cut)
            rle_host.decode_payloads(
                cut[pbase:], blkoffs, None, hdr.glob_mulfac, 512
            )


def test_validate_rejects_raw_block_overrun():
    """A raw-flagged block whose 4*cells extent exceeds the payload area
    is rejected by validate() before any decoder runs."""
    from cvxcompress_tpu import container as ctn
    from cvxcompress_tpu.utils import io as uio

    vol = volumes.radial_volume(16, 16, 16)
    data, _ = cvx.compress(vol, 1e-2, block=(8, 8, 8))
    bad = data.copy()
    # mark block 0 raw: its extent (4*512 B) far exceeds the tiny payload
    off0 = bad[32:40].view(np.int64)[0]
    bad[32:40] = np.array(
        [off0 | ctn.RAW_FLAG], dtype=np.int64
    ).view(np.uint8)
    with pytest.raises(ValueError):
        uio.validate(bad)


def test_native_decode_block_bounded():
    from cvxcompress_tpu.ops import rle_host

    if not rle_host.available():
        pytest.skip("native runtime unavailable")
    from cvxcompress_tpu.oracle import rle as orle

    payload = orle.encode(3.0, np.arange(64, dtype=np.float32))
    full = rle_host.decode_block(3.0, payload, 64)
    assert full.size == 64
    with pytest.raises(ValueError):
        rle_host.decode_block(3.0, payload[: len(payload) // 2], 64)


def test_decompress_rejects_corrupt_offsets():
    """A container whose offset table points past the payload is rejected
    before reaching the native decoder."""
    vol = volumes.radial_volume(16, 16, 16)
    data, _ = cvx.compress(vol, 1e-2, block=(8, 8, 8))
    bad = data.copy()
    # blkoffs live at [32, 32+8*nnn); poison the second entry
    bad[40:48] = np.array([2**40], dtype=np.int64).view(np.uint8)
    with pytest.raises(ValueError):
        cvx.decompress(bad, backend="jax")
