"""The oracle checks chip_smoke.py runs on the GPU: they pass on correct
containers and catch a damaged one."""

import numpy as np
import pytest

from cvxcompress_tpu import container as ctn
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.utils import checks

from conftest import make_radial_volume


@pytest.mark.parametrize(
    "shape,block",
    [
        ((40, 24, 24), (8, 8, 8)),
        ((19, 27, 41), (16, 16, 16)),   # partial edge blocks
        ((64, 64, 128), (128, 64, 32)),
        ((1, 32, 32), (16, 16, 1)),     # 2D (bz == 1)
    ],
)
def test_forward_error_within_contract(shape, block):
    vol = make_radial_volume(*shape)
    data, _ = jcodec.compress(vol, 1e-2, block=block)
    ids = checks.sample_blocks(data, 8)
    assert 0 < checks.forward_error(vol, data, ids) < 1e-5


def test_block_spans_tile_the_payload():
    vol = make_radial_volume(24, 24, 40)
    data, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    starts, sizes, is_raw = checks.block_spans(data)
    pbase = ctn.unpack(data)[3]
    assert starts[0] == pbase and not is_raw.any()
    np.testing.assert_array_equal(starts[1:], starts[:-1] + sizes[:-1])
    assert starts[-1] + sizes[-1] == data.size - ctn.SLACK_BYTES


def test_entropy_mismatch_is_caught():
    vol = make_radial_volume(24, 24, 40)
    data, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    ids = np.arange(ctn.unpack(data)[0].grid[3])
    assert checks.entropy_mismatches(vol, data, 1e-2, ids) == []
    starts, sizes, _ = checks.block_spans(data)
    bad = data.copy()
    bad[starts[5] + sizes[5] // 2] ^= 0x40
    assert checks.entropy_mismatches(vol, bad, 1e-2, ids) == [5]


def test_roundtrip_error_catches_a_wrong_volume():
    vol = make_radial_volume(24, 24, 40)
    data, _ = jcodec.compress(vol, 1e-2, block=(8, 8, 8))
    out = jcodec.decompress(data)
    ids = checks.sample_blocks(data, 16)
    assert checks.roundtrip_error(data, out, ids) < 1e-5
    assert checks.roundtrip_error(data, out * 1.001, ids) > 1e-4
