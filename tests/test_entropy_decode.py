"""Device (parallel) entropy decoder vs the sequential host decoders.

The parse result must be BIT-exact: same dequantized coefficients as
Run_Length_Decode_Slow semantics (oracle/rle.decode, native
rle_decode_block), for every token class, zero-run shape, local-RMS
scaling, and raw-fallback overlay.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import cvxcompress_tpu as cvx
from cvxcompress_tpu import container as ctn
from cvxcompress_tpu.ops import blocks as blkops
from cvxcompress_tpu.ops import codec as jcodec
from cvxcompress_tpu.ops import entropy_decode as ed

from conftest import make_radial_volume, make_sinusoid_volume


def volume_order_coeffs(data):
    """Host-decoded coefficients arranged as the padded volume plane."""
    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    coeffs = jcodec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)
    blocks = coeffs.reshape(-1, hdr.bz, hdr.by, hdr.bx)
    nbz, nby, nbx = blkops.grid_shape(
        (hdr.nz, hdr.ny, hdr.nx), (hdr.bx, hdr.by, hdr.bz)
    )
    v = blocks.reshape(
        nbz, nby, nbx, hdr.bz, hdr.by, hdr.bx
    ).transpose(0, 3, 1, 4, 2, 5)
    return v.reshape(nbz * hdr.bz * nby * hdr.by, nbx * hdr.bx)


def device_plane(data):
    p = ed.plan(data)
    assert p is not None
    hdr = p["hdr"]
    plane = ed.decode_to_volume(
        jnp.asarray(p["segs"]), jnp.asarray(p["sub_block"]),
        jnp.asarray(p["sub_reset"]), jnp.asarray(p["scalefac"]),
        (hdr.nz, hdr.ny, hdr.nx), (hdr.bx, hdr.by, hdr.bz),
        p["segs"].shape[0],
    )
    if p["raw_ids"].size:
        plane = ed.overlay_raw(
            plane, jnp.asarray(p["raw_rows"]), jnp.asarray(p["raw_ids"]),
            (hdr.nz, hdr.ny, hdr.nx), (hdr.bx, hdr.by, hdr.bz),
        )
    return np.asarray(plane)


def assert_bit_exact(data):
    got = device_plane(data)
    want = volume_order_coeffs(data)
    nxp = want.shape[1]
    # the device plane may carry lane-alignment x-padding: must be zero
    np.testing.assert_array_equal(got[:, nxp:], 0.0)
    np.testing.assert_array_equal(
        got[:, :nxp].view(np.uint32), want.view(np.uint32)
    )


@pytest.mark.parametrize(
    "shape,block,scale,lrms",
    [
        ((16, 16, 16), (8, 8, 8), 1e-2, False),
        ((19, 27, 41), (16, 16, 16), 1e-2, False),  # partial edge blocks
        ((32, 32, 32), (16, 16, 16), 1e-2, True),   # local RMS
        ((32, 32, 32), (32, 32, 32), 1e-2, False),
        ((1, 32, 32), (16, 16, 1), 1e-2, False),    # 2D (bz == 1)
        ((8, 8, 256), (256, 8, 8), 1e-3, False),    # bx = 256
    ],
)
def test_decode_radial_bit_exact(shape, block, scale, lrms):
    vol = make_radial_volume(*shape)
    data, _ = jcodec.compress(vol, scale, block=block, use_local_rms=lrms)
    assert_bit_exact(data)


def test_decode_token_class_coverage(rng):
    """Random data at several scales covers every token class: plain bytes,
    i16/i24 escapes, group-of-8 fast paths, f32 escapes, short+long runs."""
    vol = rng.standard_normal((32, 32, 64)).astype(np.float32)
    for scale in (1e-4, 1e-2, 1e-1, 1.0):
        data, _ = jcodec.compress(vol, scale, block=(16, 16, 16))
        assert_bit_exact(data)
    # huge values -> VLESC4 f32 escapes (and possibly raw-fallback blocks)
    big = (rng.standard_normal((16, 16, 32)) * 1e8).astype(np.float32)
    data, _ = jcodec.compress(big, 1e-6, block=(8, 8, 8))
    assert_bit_exact(data)


def test_decode_long_runs_and_zero_blocks():
    z = np.zeros((64, 64, 64), np.float32)
    z[0, 0, 0] = 5.0
    z[63, 63, 63] = -3.0
    data, _ = jcodec.compress(z, 1e-2, block=(64, 64, 64))
    assert_bit_exact(data)
    data, _ = jcodec.compress(np.zeros((32, 32, 32), np.float32), 1e-2,
                              block=(16, 16, 16))
    assert_bit_exact(data)


def test_decode_raw_fallback_overlay(rng):
    """Containers holding raw-fallback blocks decode via the overlay."""
    vol = (rng.standard_normal((16, 16, 32)) * 1e9).astype(np.float32)
    data, _ = jcodec.compress(vol, 1e-9, block=(8, 8, 8))
    hdr, blkoffs, _, _ = ctn.unpack(data)
    assert (np.asarray(blkoffs) < 0).any(), "fixture should hit raw fallback"
    assert_bit_exact(data)


def test_decode_multisegment_blocks(rng):
    """Block payloads far beyond one 512-byte segment exercise the
    cross-segment transfer-map scan (entry offsets + cursors)."""
    vol = rng.standard_normal((32, 32, 32)).astype(np.float32)
    data, _ = jcodec.compress(vol, 10.0, block=(32, 32, 32))
    p = ed.plan(data)
    assert (np.bincount(p["sub_block"]) > 4).any()
    assert_bit_exact(data)


def test_decode_oracle_produced_container():
    vol = make_sinusoid_volume(32, 32, 32, periods=3)
    data, _ = cvx.compress(vol, 1e-2, block=(16, 16, 16), backend="oracle")
    assert_bit_exact(data)


def test_decompress_engine_parity():
    """decompress(engine='device') equals engine='host' to transform
    tolerance (entropy stages are bit-exact; einsum shapes differ)."""
    vol = make_sinusoid_volume(64, 32, 32, periods=3)
    data, _ = jcodec.compress(vol, 1e-2, block=(32, 32, 32))
    a = jcodec.decompress(data, engine="device")
    b = jcodec.decompress(data, engine="host")
    denom = np.sqrt(np.mean(b.astype(np.float64) ** 2)) + 1e-30
    rel = np.sqrt(np.mean((a - b).astype(np.float64) ** 2)) / denom
    assert rel < 1e-6, rel
    err = np.sqrt(np.mean((a - vol) ** 2)) / np.sqrt(np.mean(vol**2))
    assert err < 2e-4


def test_decode_corrupt_payload_never_crashes(rng):
    """Bit-flipped payload bytes must decode to SOMETHING (garbage values,
    bounded positions) without raising: the device parse is fixed-shape,
    saturating, and drop-masked by construction."""
    vol = make_radial_volume(16, 16, 32)
    data, _ = jcodec.compress(vol, 1e-2, block=(16, 16, 16))
    _, _, _, pbase = ctn.unpack(data)
    for seed in range(5):
        bad = data.copy()
        r = np.random.default_rng(seed)
        flips = r.integers(pbase, data.size - 8, 20)
        bad[flips] ^= r.integers(1, 255, 20).astype(np.uint8)
        plane = device_plane(bad)  # must not raise
        assert plane.shape == (16 * 16, 128)  # x-padded to 128 lanes
        # scatter targets stay inside the two real block columns
        np.testing.assert_array_equal(plane[:, 32:], 0.0)


def synthetic_container(payload, cells, bx=8, by=8, bz=8, mulfac=2.5):
    """Wrap one hand-built block payload into a minimal valid container."""
    hdr = ctn.Header(bx, by, bz, bx, by, bz, np.float32(mulfac), False)
    return ctn.pack(hdr, [payload], [False])


def test_decode_handcrafted_boundary_straddles():
    """Hand-built streams where every token class straddles subsegment
    (32 B) boundaries at every feasible offset — the transfer-map entry
    hypotheses (E=25) all get exercised, not just encoder-typical layouts.
    Validated against the oracle decoder, then bit-exact on device."""
    cells = 512
    rng = np.random.default_rng(7)

    def stream_of(tokens):
        return b"".join(tokens)

    def vl2(v):
        return bytes([0x83]) + int(v & 0xFFFF).to_bytes(2, "little")

    def vl3(v):
        return bytes([0x81]) + int(v & 0xFFFFFF).to_bytes(3, "little")

    def vl4(f):
        return bytes([0x80]) + np.float32(f).tobytes()

    def vl2x8(vals):
        return bytes([0x82]) + np.asarray(vals, "<i2").tobytes()

    def vl3x8(vals):
        return bytes([0x7E]) + b"".join(
            int(v & 0xFFFFFF).to_bytes(3, "little") for v in vals
        )

    def rle1(run):
        return bytes([0x7F, run])

    def rle3(run):
        return bytes([0x7D]) + int(run).to_bytes(3, "little")

    cases = []
    # 25-byte tokens cycle the entry offset through every residue mod 32
    toks = [vl3x8(rng.integers(-(1 << 22), 1 << 22, 8)) for _ in range(32)]
    need = cells - 8 * len(toks)
    toks.append(rle3(need))
    cases.append(stream_of(toks))
    # 17-byte tokens cycle through odd residues; pad out with runs
    toks = [vl2x8(rng.integers(-30000, 30000, 8)) for _ in range(30)]
    toks.append(rle3(cells - 8 * len(toks)))
    cases.append(stream_of(toks))
    # mixed single-value escapes drifting across boundaries (+VLESC4 floats)
    toks = []
    emitted = 0
    k = 0
    while emitted < cells - 40:
        toks.append([vl2(200 + k), vl3(70000 + k), vl4(3e9 + k * 1e6),
                     rle1(3), bytes([k % 120 + 1])][k % 5])
        emitted += [1, 1, 1, 3, 1][k % 5]
        k += 1
    toks.append(rle3(cells - emitted))
    cases.append(stream_of(toks))
    # runs ending exactly on / one before / one after boundaries
    toks = []
    emitted = 0
    for run in (31, 32, 33, 255, 1, 2):  # runs ending around boundaries
        toks.append(bytes([5]))
        toks.append(rle1(run))
        emitted += 1 + run
    toks.append(vl3(300))
    toks.append(rle3(cells - emitted - 1))  # a >=256 run via RLESC3
    cases.append(stream_of(toks))

    from cvxcompress_tpu.oracle import rle as orle

    for payload in cases:
        want, used = orle.decode(2.5, payload + b"\x00" * 8, cells)
        assert used == len(payload)
        data = synthetic_container(np.frombuffer(payload, np.uint8), cells)
        assert_bit_exact(data)
        # and the whole thing equals the oracle's values (single 8^3 block:
        # plane rows are (z,y), real lanes 0..7)
        got = np.ascontiguousarray(device_plane(data)[:64, :8]).reshape(-1)
        np.testing.assert_array_equal(
            got.view(np.uint32), want.view(np.uint32)
        )


# (decode of a container produced by the ACTUAL reference binary — with its
# thread-completion payload order — is covered in test_reference_interop.py)
