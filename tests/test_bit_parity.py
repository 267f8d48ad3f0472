"""BIT-for-bit parity with the reference's deployed (generated plain-AVX)
wavelet path, settled by implementation.

The reference's fast transforms are generated straight-line AVX whose
accumulation order differs from its own slow oracle
(Wavelet_Transform_Slow.cpp:398-448 forward, :588-696 inverse) and whose
AVX2+FMA build differs from its plain-AVX build.  Parity is therefore
pinned to the plain-AVX (-mavx, mul+add) build — the one SIMDe also
reproduces on non-x86 CI — and implemented by
native/cvx_host.cpp:wav_*_axis_parity with the exact generated op order.

These tests build the ACTUAL reference library (same fixture as
test_reference_interop, which skips when the reference tree is absent)
and assert:
  * forward parity: the quantized coefficient streams of our parity
    compress and the reference's compress decode to bit-identical values
    (payload order differs by design: the reference's is
    thread-completion-ordered, CvxCompress.cpp:370-374)
  * inverse parity: both engines decompress either container to
    bit-identical float volumes
"""

import numpy as np
import pytest

from conftest import make_radial_volume, make_sinusoid_volume
from test_reference_interop import ref_compress, ref_decompress, ref_lib  # noqa: F401

from cvxcompress_tpu import container as ctn
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import rle_host


def decoded_coeffs(data):
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    return jcodec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)


@pytest.fixture(scope="module")
def native():
    if not rle_host.available():
        pytest.skip("native runtime unavailable")
    return rle_host


@pytest.mark.parametrize("shape,block", [
    ((48, 64, 96), (32, 32, 32)),
    ((32, 32, 32), (16, 16, 16)),
    ((16, 32, 64), (64, 8, 8)),
])
def test_forward_bit_parity(ref_lib, native, shape, block):  # noqa: F811
    vol = make_radial_volume(*shape)
    ours, _ = native.host_compress(vol, 1e-2, block=block, parity=True)
    ref, _ = ref_compress(ref_lib, vol, 1e-2, block)
    # identical quantized coefficients => identical per-block payloads
    np.testing.assert_array_equal(
        decoded_coeffs(ours).view(np.uint32),
        decoded_coeffs(ref).view(np.uint32),
    )
    # and identical container length (size parity is exact, not just <=)
    assert ours.size == ref.size


def test_inverse_bit_parity(ref_lib, native):  # noqa: F811
    vol = make_sinusoid_volume(64, 64, 96, periods=3)
    ref, _ = ref_compress(ref_lib, vol, 1e-2, (32, 32, 32))
    a = native.host_decompress(ref, parity=True)
    b = ref_decompress(ref_lib, ref)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # roundtrip entirely through our parity engine matches the reference's
    # decompress of OUR container too
    ours, _ = native.host_compress(vol, 1e-2, block=(32, 32, 32),
                                   parity=True)
    c = native.host_decompress(ours, parity=True)
    d = ref_decompress(ref_lib, ours)
    np.testing.assert_array_equal(c.view(np.uint32), d.view(np.uint32))


def test_local_rms_bit_parity(ref_lib, native):  # noqa: F811
    """Local-RMS containers: the parity engine replicates the reference's
    f32 SIMD-lane RMS accumulation (Compute_Local_RMS,
    CvxCompress.cpp:119-142) — per-block mulfac tables and coefficient
    streams are bit-identical."""
    import ctypes

    f32p = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint)
    ref_lib.cvx_compress_th.restype = ctypes.c_float
    ref_lib.cvx_compress_th.argtypes = [
        ctypes.c_float, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_bool, u32p, ctypes.c_int, ctypes.POINTER(ctypes.c_long),
    ]

    vol = make_radial_volume(32, 32, 64)
    nz, ny, nx = vol.shape
    out = np.zeros(vol.nbytes * 2 + (1 << 16), dtype=np.uint8)
    length = ctypes.c_long(0)
    ref_lib.cvx_compress_th(
        ctypes.c_float(1e-2), vol.ctypes.data_as(f32p),
        nx, ny, nz, 16, 16, 16, ctypes.c_bool(True),
        out.ctypes.data_as(u32p), 4, ctypes.byref(length),
    )
    ref = out[: length.value].copy()
    ours, _ = native.host_compress(vol, 1e-2, block=(16, 16, 16),
                                   use_local_rms=True, parity=True)
    # identical per-block mulfac tables...
    h_r, _, mf_r, _ = ctn.unpack(ref)
    h_o, _, mf_o, _ = ctn.unpack(ours)
    np.testing.assert_array_equal(
        mf_o.view(np.uint32), mf_r.view(np.uint32)
    )
    # ...identical decoded coefficient streams and container size
    np.testing.assert_array_equal(
        decoded_coeffs(ours).view(np.uint32),
        decoded_coeffs(ref).view(np.uint32),
    )
    assert ours.size == ref.size
    # and bit-identical decompressed floats via the parity inverse
    a = native.host_decompress(ref, parity=True)
    b = ref_decompress(ref_lib, ref)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_parity_engine_roundtrip_quality(native):
    vol = make_sinusoid_volume(64, 32, 32, periods=3)
    data, ratio = native.host_compress(vol, 1e-2, block=(32, 32, 32),
                                       parity=True)
    out = native.host_decompress(data, parity=True)
    err = np.sqrt(np.mean((out - vol) ** 2)) / np.sqrt(np.mean(vol**2))
    assert err < 2e-4 and ratio > 100
