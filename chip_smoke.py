"""Smoke test of the codec on the GPU: its main path at the reference's sizes.

    python chip_smoke.py             one GPU, phases a-g
    python chip_smoke.py --sharded   four GPUs of one host, phase h only

  a  device check: JAX's first device is a GPU; card name and power limit
  b  the reference CI config (Test_With_Generated_Input.cpp): a 320x416x352
     (x, y, z) z-sinusoid, 32^3 blocks, scale 1e-2, global RMS — quality
     bars, ratio, forward transform vs the oracle, entropy bytes vs the
     oracle encoder, device parse vs host decoder
  c  384^3 at 128^3 blocks, global and local RMS: (b)'s checks
  d  radial + noise volume (Read_Raw_Volume.cpp) at scale 1e-3, CI-config
     size: the cap-overflow repack; then raw-fallback blocks; round trips
     vs the oracle decoder
  e  batched streams over 8 CI-config volumes: containers byte-identical to
     per-volume compress
  f  DeviceSnapshotStack: 16 CI-config snapshots appended, popped in reverse
  g  warm median and spread of each phase's compress and decompress, and of
     both decompress engines at the CI config
  h  (--sharded) parallel.compress / decompress on a 4-GPU mesh vs one GPU,
     at the CI config and at 384^3 / 128^3

Every phase asserts; a failure exits non-zero.  The last line of standard
output is one JSON object naming the device JAX computed on.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from cvxcompress_tpu.utils import cache
from cvxcompress_tpu.utils.profiling import card_line, timed

CI_SHAPE = (352, 416, 320)  # (nz, ny, nx)
CI_BLOCK = (32, 32, 32)
CI_PERIODS = 10
BIG_SHAPE = (384, 384, 384)
BIG_BLOCK = (128, 128, 128)
SCALE = 1e-2
SAMPLE = 64  # blocks checked against the oracle per container


def log(*a):
    print(*a, flush=True)


def result_line(devices):
    """The last line: the device JAX computed on, as JAX reports it."""
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devices),
        },
    })


def fmt_time(name, t, cells):
    med, lo, hi = t
    return (f"time {name}: median {med * 1e3:.3f} ms "
            f"(min {lo * 1e3:.3f}, max {hi * 1e3:.3f}) = "
            f"{cells / med / 1e6:.1f} MCells/s")


def gain(k, n):
    """Distinct signed powers of two: volume k of n is the CI input times
    gain(k, n).  It quantizes to exactly the CI input's integers, signed
    (the mulfac scales by the inverse power of two), so it must meet the
    reference's bars, while a volume returned out of order misses them by
    a factor of two."""
    return (-1.0) ** k * 2.0 ** (k - n // 2)


def sinusoid(shape, periods=CI_PERIODS, gain=1.0):
    """The CI input vol[z] = sin(z * pi * periods / nz)
    (volumes.sinusoid_volume), times `gain`."""
    nz, ny, nx = shape
    z = gain * np.sin(np.arange(nz) * np.pi * periods / nz)
    return np.broadcast_to(z.astype(np.float32)[:, None, None], shape).copy()


def check_container(vol, data, scale, sample=SAMPLE, forward=True):
    """(b)'s oracle checks on one container; returns the sampled ids."""
    from cvxcompress_tpu.utils import checks

    ids = checks.sample_blocks(data, sample)
    if forward:
        fe = checks.forward_error(vol, data, ids)
        log(f"  forward transform vs oracle: worst block rel-RMS {fe:.3e}")
        assert fe < 1e-5, fe
    bad = checks.entropy_mismatches(vol, data, scale, ids)
    log(f"  entropy bytes vs oracle encoder: {len(ids) - len(bad)}/"
        f"{len(ids)} blocks identical")
    assert not bad, bad
    assert checks.decoders_agree(data), "device parse != host decoder"
    log("  device parse vs host decoder: coefficient planes bit-identical")
    return ids


def phase_ci(shape=CI_SHAPE, block=CI_BLOCK, periods=CI_PERIODS, reps=5):
    """(b): returns (ratio, timings)."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.ops import codec, rle_host
    from cvxcompress_tpu.utils import checks

    # the host engine and the decoder check run the native decoder
    assert rle_host.available(), "native host runtime did not build"
    vol = sinusoid(shape, periods)
    data, ratio = cvx.compress(vol, SCALE, block=block)
    out = cvx.decompress(data)
    err, snr = checks.quality(vol, out)
    log(f"  ratio {ratio:.1f}:1  err {err:.3e}  SNR {snr:.2f} dB  "
        f"(auto engine: {codec.auto_engine()})")
    assert err < 2e-4 and snr > 75.0, (err, snr)
    check_container(vol, data, SCALE)
    dev = codec.decompress(data, engine="device")
    host = codec.decompress(data, engine="host")
    rel = checks.quality(host, dev)[0]
    log(f"  device vs host engine volumes: rel-RMS {rel:.3e}")
    assert rel < 1e-6, rel
    t = {
        "compress": timed(lambda: cvx.compress(vol, SCALE, block=block),
                          reps),
        "decompress[device engine]": timed(
            lambda: codec.decompress(data, engine="device"), reps),
        "decompress[host engine]": timed(
            lambda: codec.decompress(data, engine="host"), reps),
    }
    return ratio, t


def phase_big(shape=BIG_SHAPE, block=BIG_BLOCK, periods=CI_PERIODS, reps=5):
    """(c): global and local RMS; returns timings."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.utils import checks

    vol = sinusoid(shape, periods)
    t = {}
    for local in (False, True):
        tag = "local" if local else "global"
        data, ratio = cvx.compress(vol, SCALE, block=block,
                                   use_local_rms=local)
        out = cvx.decompress(data)
        err, snr = checks.quality(vol, out)
        log(f"  {tag} RMS: ratio {ratio:.1f}:1  err {err:.3e}  "
            f"SNR {snr:.2f} dB")
        # the forward transform does not depend on the RMS mode
        check_container(vol, data, SCALE, forward=not local)
        t[f"compress[{tag}]"] = timed(
            lambda: cvx.compress(vol, SCALE, block=block,
                                 use_local_rms=local), reps)
        t[f"decompress[{tag}]"] = timed(lambda: cvx.decompress(data), reps)
    return t


def phase_radial(shape=CI_SHAPE, block=CI_BLOCK, sample=32, reps=5):
    """(d): returns timings."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu import container as ctn
    from cvxcompress_tpu.ops import codec, rle_device
    from cvxcompress_tpu.utils import checks, volumes

    vol = volumes.radial_volume(*shape)
    key = (shape, block, False, rle_device.chunk_cells(int(np.prod(block))))
    caps_before = codec._CAPS_CACHE.get(key)
    data, ratio = cvx.compress(vol, 1e-3, block=block)
    caps_after = codec._CAPS_CACHE[key]
    repacked = caps_before is not None and caps_after[0] > caps_before[0]
    log(f"  scale 1e-3: ratio {ratio:.2f}:1  cap-overflow repack: "
        f"{'yes' if repacked else 'no'} (caps {caps_before} -> "
        f"{caps_after})")
    out = cvx.decompress(data)
    ids = checks.sample_blocks(data, sample)
    rt = checks.roundtrip_error(data, out, ids)
    log(f"  round trip vs oracle decoder: worst block rel-RMS {rt:.3e}")
    assert rt < 1e-5, rt
    assert checks.decoders_agree(data), "device parse != host decoder"
    t = {
        "compress[1e-3]": timed(lambda: cvx.compress(vol, 1e-3, block=block),
                                reps),
        "decompress[1e-3]": timed(lambda: cvx.decompress(data), reps),
    }

    # raw fallback: a first z-layer of blocks of loud noise at a scale so
    # fine that its blocks encode larger than raw (CvxCompress.cpp:350-360)
    rng = np.random.default_rng(1)
    loud = vol.copy()
    loud[:block[2]] = rng.standard_normal(loud[:block[2]].shape) * 1e4
    data2, _ = cvx.compress(loud, 1e-8, block=block)
    raw = np.asarray(ctn.unpack(data2)[1]) < 0
    log(f"  raw fallback: {int(raw.sum())} of {raw.size} blocks raw")
    assert 0 < raw.sum() < raw.size
    out2 = cvx.decompress(data2)
    ids2 = np.union1d(np.flatnonzero(raw)[:sample // 2],
                      checks.sample_blocks(data2, sample // 2))
    rt2 = checks.roundtrip_error(data2, out2, ids2)
    log(f"  raw-fallback round trip vs oracle decoder: worst block "
        f"rel-RMS {rt2:.3e}")
    assert rt2 < 1e-5, rt2
    assert checks.decoders_agree(data2), "device parse != host decoder"
    return t


def phase_stream(shape=CI_SHAPE, block=CI_BLOCK, periods=CI_PERIODS, n=8,
                 batch=4):
    """(e): returns per-volume timings of a second, warm pass."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu import pipeline
    from cvxcompress_tpu.utils import checks

    vols = [sinusoid(shape, periods, gain=gain(k, n)) for k in range(n)]

    def enc():
        return [d for d, _ in pipeline.compress_stream_batched(
            vols, SCALE, block=block, batch=batch)]

    def dec(datas):
        return list(pipeline.decompress_stream_batched(datas, batch=batch))

    datas = enc()
    for k, (v, d) in enumerate(zip(vols, datas)):
        one = cvx.compress(v, SCALE, block=block)[0]
        assert np.array_equal(d, one), f"stream container {k} != compress"
    log(f"  {n} stream containers byte-identical to per-volume compress")
    outs = dec(datas)
    for k, (v, o) in enumerate(zip(vols, outs)):
        err, snr = checks.quality(v, o)
        assert err < 2e-4 and snr > 75.0, (k, err, snr)
        rel = checks.quality(cvx.decompress(datas[k]), o)[0]
        assert rel < 1e-6, (k, rel)
    log(f"  {n} stream decodes meet the quality bars and match decompress")
    t0 = time.perf_counter()
    enc()
    tc = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    dec(datas)
    td = (time.perf_counter() - t0) / n
    return {"stream compress per volume": (tc, tc, tc),
            "stream decompress per volume": (td, td, td)}


def phase_snapshots(shape=CI_SHAPE, block=CI_BLOCK, periods=CI_PERIODS,
                    n=16):
    """(f): returns per-snapshot timings of a second, warm pass."""
    import jax
    import jax.numpy as jnp

    from cvxcompress_tpu import DeviceSnapshotStack
    from cvxcompress_tpu.utils import checks

    nz = shape[0]

    @jax.jit
    def snapshot(g):  # the wavefield is born on the device
        z = jnp.sin(jnp.arange(nz) * jnp.pi * periods / nz)
        z = z.astype(jnp.float32) * g
        return jnp.broadcast_to(z[:, None, None], shape)

    gains = [jnp.float32(gain(k, n)) for k in range(n)]
    store = DeviceSnapshotStack(shape, SCALE, block=block)

    def fill():
        vols = [snapshot(g) for g in gains]
        jax.block_until_ready(vols)
        t0 = time.perf_counter()
        for v in vols:
            store.append(v)
        store.flush()
        jax.block_until_ready(store._snaps[-1][0])
        return (time.perf_counter() - t0) / n

    def drain(check):
        t = 0.0
        for k in reversed(range(n)):
            t0 = time.perf_counter()
            out = jax.block_until_ready(store.pop())
            t += time.perf_counter() - t0
            if check:
                err, snr = checks.quality(snapshot(gains[k]), out)
                assert err < 2e-4 and snr > 75.0, (k, err, snr)
        assert len(store) == 0
        return t / n

    fill()
    drain(check=True)
    log(f"  {n} snapshots popped in LIFO order, each within the bars")
    ta = fill()
    tp = drain(check=False)
    return {"snapshot append": (ta, ta, ta), "snapshot pop": (tp, tp, tp)}


def phase_sharded(devices, cases=((CI_SHAPE, CI_BLOCK), (BIG_SHAPE, BIG_BLOCK)),
                  reps=3):
    """(h): containers byte-identical to one device, volumes within 1e-6."""
    import cvxcompress_tpu as cvx
    from cvxcompress_tpu.parallel import compress as pcompress
    from cvxcompress_tpu.parallel import mesh as meshlib
    from cvxcompress_tpu.utils import checks

    mesh = meshlib.make_mesh(devices)
    for shape, block in cases:
        vol = sinusoid(shape)
        cells = vol.size
        data, _ = pcompress.compress(vol, SCALE, block=block, mesh=mesh)
        one, _ = cvx.compress(vol, SCALE, block=block)
        assert np.array_equal(data, one), f"{shape}: sharded != one device"
        out = pcompress.decompress(data, mesh=mesh)
        rel = checks.quality(cvx.decompress(one), out)[0]
        log(f"  {shape} / {block}: container byte-identical to one device; "
            f"decoded rel-RMS vs one device {rel:.3e}")
        assert rel < 1e-6, rel
        n = len(devices)
        for name, fn in (
            (f"{n}-device compress", lambda: pcompress.compress(
                vol, SCALE, block=block, mesh=mesh)),
            (f"{n}-device decompress", lambda: pcompress.decompress(
                data, mesh=mesh)),
            ("1-device compress", lambda: cvx.compress(
                vol, SCALE, block=block)),
            ("1-device decompress", lambda: cvx.decompress(one)),
        ):
            log("  " + fmt_time(f"{shape} {name}", timed(fn, reps), cells))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="run only the 4-GPU mesh phase (h)")
    args = ap.parse_args(argv)

    cache.enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX computes on "
              f"{devices[0].platform}", file=sys.stderr)
        return 2
    need = 4 if args.sharded else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 2
    log(f"(a) card: {card_line()}")
    log(f"    jax {jax.__version__}; {len(devices)} x {devices[0].device_kind}")

    if args.sharded:
        log("(h) 4-GPU mesh vs one GPU")
        phase_sharded(devices[:4])
        print(result_line(devices), flush=True)
        return 0

    times = {}
    cells = int(np.prod(CI_SHAPE))
    log(f"(b) CI config {CI_SHAPE} (nz, ny, nx), {CI_BLOCK} blocks")
    ratio, times["b"] = phase_ci()
    assert 900.0 < ratio < 1500.0, ratio
    log(f"(c) {BIG_SHAPE} at {BIG_BLOCK} blocks")
    times["c"] = phase_big()
    log("(d) radial + noise volume")
    times["d"] = phase_radial()
    log("(e) batched streams")
    times["e"] = phase_stream()
    log("(f) DeviceSnapshotStack")
    times["f"] = phase_snapshots()
    log(f"(g) timings, card {card_line()}")
    for ph, tt in times.items():
        n = int(np.prod(BIG_SHAPE)) if ph == "c" else cells
        for name, t in tt.items():
            log("  " + fmt_time(f"({ph}) {name}", t, n))
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
