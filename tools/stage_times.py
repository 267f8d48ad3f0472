#!/usr/bin/env python
"""Time each stage of the codec's XLA path on the GPU, with its roofline share.

Compress: host RMS, h2d, forward wavelet (codec._stage_w), tokenize
(rle_device.tokenize_desc), pack (rle_device.pack_active + the output
bundle), d2h, host container assembly.  Decompress, device engine: host
plan, h2d, entropy parse + expand (entropy_decode.decode_to_volume),
inverse wavelet, d2h, and the parse+inverse program the codec runs;
host engine: host entropy decode, chunk-sparse expand + inverse.

Each stage is timed alone on warm inputs, ending in block_until_ready (or
a host result): median, min and max of --reps calls.  A device stage's
bytes are what its jit reads and writes (array sizes; gathers count only
the rows they read), and its roofline share is bytes / peak bandwidth /
time against the card's published HBM bandwidth.  h2d and d2h report
GB/s over PCIe instead.

Usage: python tools/stage_times.py [--reps 10] [--out chiprun_out/stage_times.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from cvxcompress_tpu.utils import profiling  # noqa: E402

# Published HBM bandwidth by JAX device_kind (NVIDIA H100 SXM data sheet).
PEAK_BYTES_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

CONFIGS = (
    ("ci_32c", (352, 416, 320), (32, 32, 32)),
    ("384_128c", (384, 384, 384), (128, 128, 128)),
)


def _timed(fn, reps, setup=None):
    med, lo, hi = profiling.timed(fn, reps, setup)
    return {"median_s": med, "min_s": lo, "max_s": hi}


def _nbytes(*arrays):
    return int(sum(a.size * a.dtype.itemsize for a in arrays))


def compress_stages(vol, block, scale, reps):
    """{stage: timing + bytes} for one compress of a host volume."""
    import jax
    import jax.numpy as jnp

    from cvxcompress_tpu import container as ctn
    from cvxcompress_tpu.ops import codec, quant, rle_device

    cells = int(np.prod(block))
    chunk = rle_device.chunk_cells(cells)
    out = {}
    out["host rms"] = _timed(lambda: quant.global_rms_host(vol), reps)
    mf = ctn.compute_glob_mulfac(quant.global_rms_host(vol), scale)
    out["h2d volume"] = _timed(
        lambda: jax.device_put(vol).block_until_ready(), reps)
    out["h2d volume"]["pcie_bytes"] = vol.nbytes
    vd = jax.device_put(vol)
    mfd, sd = jnp.float32(mf), jnp.float32(scale)

    def w():
        return jax.block_until_ready(
            codec._stage_w(vd, mfd, sd, False, block, chunk))

    rows, chunks, mfs = w()
    out["forward wavelet"] = _timed(w, reps)
    out["forward wavelet"]["bytes"] = _nbytes(vd, rows, chunks, mfs)
    n = mfs.shape[0]

    def t():
        return jax.block_until_ready(
            rle_device.tokenize_desc(rows, n, chunk))

    desc, cb, sizes, raw, counts = t()
    out["tokenize"] = _timed(t, reps)
    out["tokenize"]["bytes"] = _nbytes(rows, desc, cb, sizes, raw, counts)
    acap, lcap, skip = codec._derive_caps(np.asarray(counts))

    def p():
        sub, aidx, ab = rle_device.pack_active(
            chunks, desc, cb, acap, lcap, skip_squeeze=skip)
        return jax.block_until_ready(
            codec._bundle_outputs(sub, aidx, ab, sizes, raw, counts, mfs))

    bundle = p()
    out["pack + bundle"] = _timed(p, reps)
    # active rows of both planes, the chunk table, the bundle written
    out["pack + bundle"]["bytes"] = (
        acap * chunk * 8 + _nbytes(cb) + _nbytes(bundle))
    # a fresh device copy per call: a jax.Array caches its host value
    out["d2h bundle"] = _timed(
        np.asarray, reps, setup=lambda: jax.block_until_ready(bundle.copy()))
    out["d2h bundle"]["pcie_bytes"] = _nbytes(bundle)

    ctx = codec._compress_stage(vol, scale, block, False, mf)
    blob = np.asarray(ctx["bundle"])
    out["host assembly"] = _timed(
        lambda: codec._compress_finish(ctx, blob), reps)
    out["compress (end to end)"] = _timed(
        lambda: codec.compress(vol, scale, block=block), reps)
    return out, codec.compress(vol, scale, block=block)[0]


def decompress_stages(data, reps):
    """{stage: timing + bytes} for both decompress engines."""
    import jax

    from cvxcompress_tpu import container as ctn
    from cvxcompress_tpu.ops import codec, rle_device
    from cvxcompress_tpu.ops import entropy_decode as ed

    hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
    vol_shape = (hdr.nz, hdr.ny, hdr.nx)
    block = (hdr.bx, hdr.by, hdr.bz)
    cells = hdr.bx * hdr.by * hdr.bz
    chunk = rle_device.chunk_cells(cells)
    out = {}
    out["host plan"] = _timed(lambda: ed.plan(data), reps)
    p = ed.plan(data)

    def up():
        return jax.block_until_ready(codec._upload_plan(p))

    segs, sb, sr, sf = up()
    out["h2d plan"] = _timed(up, reps)
    out["h2d plan"]["pcie_bytes"] = _nbytes(segs, sb, sr, sf)
    nseg = p["segs"].shape[0]

    def parse():
        return jax.block_until_ready(ed.decode_to_volume(
            segs, sb, sr, sf, vol_shape, block, nseg))

    plane = parse()
    out["parse + expand"] = _timed(parse, reps)
    out["parse + expand"]["bytes"] = _nbytes(segs, sb, sr, sf, plane)

    def inv():
        return jax.block_until_ready(
            codec._inverse_volume_plane(plane, vol_shape, block))

    vol_d = inv()
    out["inverse wavelet"] = _timed(inv, reps)
    out["inverse wavelet"]["bytes"] = _nbytes(plane, vol_d)

    def fused():
        return jax.block_until_ready(codec._decode_and_inverse(
            segs, sb, sr, sf, vol_shape, block, nseg))

    out["parse + inverse (one program)"] = _timed(fused, reps)
    out["parse + inverse (one program)"]["bytes"] = _nbytes(
        segs, sb, sr, sf, vol_d)
    out["d2h volume"] = _timed(
        np.asarray, reps, setup=lambda: jax.block_until_ready(vol_d.copy()))
    out["d2h volume"]["pcie_bytes"] = _nbytes(vol_d)
    out["decompress[device engine] (end to end)"] = _timed(
        lambda: codec.decompress(data, engine="device"), reps)

    out["host entropy decode"] = _timed(
        lambda: codec._decode_payloads_host(data, hdr, blkoffs, blkmf,
                                            pbase), reps)
    coeffs = codec._decode_payloads_host(data, hdr, blkoffs, blkmf, pbase)
    out["host sparse chunks"] = _timed(
        lambda: codec.sparse_chunks(coeffs, cells, chunk), reps)
    pay, invmap, _ = codec.sparse_chunks(coeffs, cells, chunk)
    pay_d, inv_d = jax.device_put(pay), jax.device_put(invmap)

    def expand_inv():
        return jax.block_until_ready(codec._decompress_sparse(
            pay_d, inv_d, vol_shape, block, chunk))

    expand_inv()
    out["expand + inverse (host engine)"] = _timed(expand_inv, reps)
    out["expand + inverse (host engine)"]["bytes"] = _nbytes(
        pay, invmap, vol_d)
    out["decompress[host engine] (end to end)"] = _timed(
        lambda: codec.decompress(data, engine="host"), reps)
    return out


def add_rates(stages, peak):
    for v in stages.values():
        t = v["median_s"]
        if "bytes" in v:
            v["gb_s"] = v["bytes"] / t / 1e9
            v["roofline_share"] = v["bytes"] / peak / t
        if "pcie_bytes" in v:
            v["gb_s"] = v["pcie_bytes"] / t / 1e9
    return stages


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="chiprun_out/stage_times.json")
    args = ap.parse_args()

    from cvxcompress_tpu.utils import cache

    cache.enable_compile_cache()
    import jax

    from cvxcompress_tpu.utils import volumes

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"stage_times: needs a GPU, JAX computes on {dev.platform}",
              file=sys.stderr)
        return 2
    peak = PEAK_BYTES_S[dev.device_kind]  # unknown cards are an error
    card = profiling.card_line()
    report = {"card": card, "device_kind": dev.device_kind,
              "peak_bytes_s": peak, "reps": args.reps, "configs": {}}
    print(f"card: {card}")
    for name, shape, block in CONFIGS:
        vol = volumes.sinusoid_volume(*shape)
        comp, data = compress_stages(vol, block, 1e-2, args.reps)
        dec = decompress_stages(data, args.reps)
        report["configs"][name] = {
            "shape": shape, "block": block,
            "compress": add_rates(comp, peak),
            "decompress": add_rates(dec, peak),
        }
        for part in ("compress", "decompress"):
            for stage, v in report["configs"][name][part].items():
                extra = ""
                if "roofline_share" in v:
                    extra = (f"  {v['bytes'] / 1e6:.1f} MB  "
                             f"{v['gb_s']:.1f} GB/s  "
                             f"roofline {100 * v['roofline_share']:.1f}%")
                elif "gb_s" in v:
                    extra = f"  {v['gb_s']:.1f} GB/s (PCIe)"
                print(f"{name} {part:10s} {stage:40s} "
                      f"{v['median_s'] * 1e3:9.3f} ms "
                      f"[{v['min_s'] * 1e3:.3f}, {v['max_s'] * 1e3:.3f}]"
                      f"{extra}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
