"""Oracle wavelet transform: mirror math, schedules, perfect reconstruction."""

import numpy as np
import pytest

from cvxcompress_tpu.oracle import wavelet as w


def scalar_mirr(v, n):
    # direct restatement of Wavelet_Transform_Slow.cpp:59-67
    v = -v if v < 0 else v
    v = 2 * n - 2 - v if v >= n else v
    v = -v if v < 0 else v
    v = 2 * n - 2 - v if v >= n else v
    return v


def test_mirr_matches_scalar():
    for n in (2, 4, 8, 16):
        for i in range(-8, n + 8):
            assert w.mirr(i, n) == scalar_mirr(i, n), (i, n)
        # in-range over the indices the transform actually produces:
        # even outputs i0 = 2*ix reach offsets +-4, odd i0 = 2*ix+1 reach +-3
        nh, nl = n // 2, n - n // 2
        for ix in range(nl):
            for off in (-4, -3, -2, -1, 1, 2, 3, 4):
                assert 0 <= w.mirr(2 * ix + off, n) < n
        for ix in range(nh):
            for off in (-3, -2, -1, 1, 2, 3):
                assert 0 <= w.mirr(2 * ix + 1 + off, n) < n


def test_mirr_sl_sh_in_range():
    # offsets actually used by Us79 (Wavelet_Transform_Slow.cpp:230-248):
    # SL band: t[k-1 .. k+2], SH band: t[nl+k-2 .. nl+k+2]
    for n in (2, 4, 8, 16, 32):
        nh, nl = n // 2, n - n // 2
        for k in range(max(nl, nh)):
            for off in (-1, 0, 1, 2):
                assert 0 <= w.mirr_sl(k + off, nl) < nl
            for off in (-2, -1, 0, 1, 2):
                v = w.mirr_sh(nl + k + off, nl, nh)
                assert nl <= v < n, (n, k, off, v)


def test_level_schedule():
    assert w.level_schedule(256) == [256, 128, 64, 32, 16, 8, 4, 2]
    assert w.level_schedule(8) == [8, 4, 2]
    assert w.level_schedule(1) == []


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256])
def test_1d_roundtrip(n, rng):
    x = rng.standard_normal(n).astype(np.float32)
    y = w.us79(w.ds79(x))
    err = np.linalg.norm(y - x) / np.linalg.norm(x)
    assert err < 1e-5, err


@pytest.mark.parametrize(
    "shape",
    [(8, 8, 8), (16, 8, 32), (32, 32, 32), (1, 16, 16), (8, 64, 8)],
)
def test_3d_roundtrip(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    y = w.inverse_3d(w.forward_3d(x))
    err = np.linalg.norm(y - x) / np.linalg.norm(x)
    assert err < 1e-5, err


def test_linearity(rng):
    # the multi-level transform is linear: basis for the matmul design
    a = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    lhs = w.ds79((2.0 * a + 3.0 * b).astype(np.float32))
    rhs = 2.0 * w.ds79(a) + 3.0 * w.ds79(b)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4, atol=1e-5)


def test_dc_gain():
    # lowpass of a constant signal concentrates energy in the L band
    x = np.ones(64, dtype=np.float32)
    y = w.ds79(x)
    # multi-level lowpass DC gain = sqrt(2) per level, 6 levels on n=64 -> 8
    assert abs(abs(y[0]) - 8.0) < 1e-3
    assert np.max(np.abs(y[1:])) < 1e-4 * abs(y[0])


def test_forward_changes_layout_lh():
    # one level on length-2: [L|H]
    x = np.array([1.0, 0.0], dtype=np.float32)
    y = w.ds79(x)
    assert y.shape == (2,)
    # reconstruction still exact
    np.testing.assert_allclose(w.us79(y), x, atol=1e-6)
