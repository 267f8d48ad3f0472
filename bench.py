"""Benchmark: codec throughput on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MCells/s", "vs_baseline": N, ...}

Headline: harmonic-mean compress+decompress DEVICE-PIPELINE throughput on
the reference's end-to-end CI config (320x416x352 sinusoid — the exact
Test_With_Generated_Input.cpp input, quality bars asserted in-bench —
32^3 blocks, scale 1e-2, global RMS; the reference publishes
2,150 / 7,303 MC/s on a multi-core AVX CPU, README.md:79, harmonic mean
1,660 MC/s).

"Device pipeline" = everything the device does per volume: forward
wavelet, tokenize, active-chunk packing (compress); entropy parse
(ops.entropy_decode), scatter-expand, and inverse wavelet (decompress).
Each is timed as a window of back-to-back calls ended by
block_until_ready, over several windows: median and spread.  The
recurring HOST work per volume (container assembly on compress, segment
planning on decompress) is measured separately and reported in `detail`
(host_assembly_ms / host_plan_ms).  The sustained stage streams volumes
through the BATCHED stream APIs (pipeline.compress_stream_batched /
decompress_stream_batched) with all host work charged.

Evidence discipline:
  * a WALL-CLOCK BUDGET (--budget, default 300 s) gates every stage;
    stages that would not fit are skipped and listed in detail.skipped
  * partial results flush to BENCH_partial.json after every stage
  * the final JSON line always prints; a stage that raised is recorded in
    detail.error and the process then exits non-zero
  * it needs a GPU: without one it exits non-zero before measuring

Usage: python bench.py [--quick] [--budget SECONDS]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

BASELINE_ROUNDTRIP = 1660.0  # MC/s, harmonic mean of reference 2150/7303
BASELINE_COMPRESS = 2150.0
BASELINE_DECOMPRESS = 7303.0

PARTIAL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "BENCH_partial.json")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Budget:
    """Wall-clock budget: stages check in before starting."""

    def __init__(self, total_s):
        self.t0 = time.monotonic()
        self.total = total_s
        self.skipped = []

    def elapsed(self):
        return time.monotonic() - self.t0

    def left(self):
        return self.total - self.elapsed()

    def admit(self, name, need_s):
        """True if `name` fits in the remaining budget, else record skip."""
        if self.left() >= need_s:
            return True
        self.skipped.append(name)
        log(f"[budget] skip {name}: need ~{need_s:.0f}s, "
            f"{self.left():.0f}s left")
        return False


def flush_partial(detail):
    """Write the partial record after every stage (kill-safe evidence)."""
    try:
        with open(PARTIAL_PATH, "w") as f:
            json.dump(detail, f)
    except OSError:
        pass


def make_volume(nz, ny, nx, periods=10):
    """The reference CI input: pure sinusoid x-slices, NO added noise
    (Test_With_Generated_Input.cpp:45-51) — quality and vs_baseline are
    measured on the same data the published baselines used."""
    from cvxcompress_tpu.utils import volumes

    return volumes.sinusoid_volume(nz, ny, nx, periods=periods)


def window_time(run, iters, reps=3):
    """Seconds per call of run(j): a warm call, then `reps` windows of
    `iters` back-to-back calls, each ended by block_until_ready on the
    last result (the device runs them in order).  Returns (median, min,
    max) over the windows."""
    import jax

    jax.block_until_ready(run(0))
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for j in range(iters):
            out = run(j)
        jax.block_until_ready(out)
        per.append((time.perf_counter() - t0) / iters)
    return statistics.median(per), min(per), max(per)


def bench_device_compress(vol, block, scale, iters=6, reps=3,
                          use_local=False):
    """Per-volume device time of the full compress pipeline (W+T+P jits)."""
    import jax
    import jax.numpy as jnp

    from cvxcompress_tpu.ops import codec as jcodec
    from cvxcompress_tpu.ops import rle_device

    chunk = rle_device.chunk_cells(int(np.prod(block)))
    v0 = jax.device_put(vol)
    vd = [v0, v0 * jnp.float32(1.0000001)]
    mf0, sc = jnp.float32(123.4), jnp.float32(scale)
    counts = jcodec._encode_device(vd[0], mf0, sc, use_local, block,
                                   chunk)[5]
    acap, lcap, skip = jcodec._derive_caps(np.asarray(counts))

    def full(j):
        chunks, desc, cb, sizes, raw, counts, mf = jcodec._encode_device(
            vd[j % 2], mf0, sc, use_local, block, chunk
        )
        return rle_device.pack_active(
            chunks, desc, cb, acap, lcap, skip_squeeze=skip
        )[0]

    return window_time(full, iters, reps)


def bench_device_decompress(data, vol_shape, iters=6, reps=3):
    """Per-volume device time of the FULL decompress pipeline.

    Entropy parse (ops.entropy_decode) + scatter-expand + inverse wavelet,
    all on device.  Also returns the host-side segment-planning time.
    """
    import jax
    import jax.numpy as jnp

    from cvxcompress_tpu.ops import codec as jcodec
    from cvxcompress_tpu.ops import entropy_decode as ed

    t0 = time.perf_counter()
    p = ed.plan(data)
    t_plan = time.perf_counter() - t0
    assert p is not None and not p["raw_ids"].size
    hdr = p["hdr"]
    block = (hdr.bx, hdr.by, hdr.bz)
    segs = [jax.device_put(p["segs"]), jax.device_put(p["segs"].copy())]
    sblk = jnp.asarray(p["sub_block"])
    sfst = jnp.asarray(p["sub_reset"])
    ssf = jnp.asarray(p["scalefac"])
    nseg = p["segs"].shape[0]

    def run(j):
        return jcodec._decode_and_inverse(
            segs[j % 2], sblk, sfst, ssf, vol_shape, block, nseg
        )

    return window_time(run, iters, reps), t_plan


def bench_sustained(vol, block, scale, n_vols=8, batch=4):
    """Sustained roundtrip throughput INCLUDING the recurring host work.

    Streams n_vols DEVICE-RESIDENT volumes through the BATCHED stream
    APIs — the production RTM shape (volumes are born on the device,
    containers leave to host, reconstructions stay on the device).  All
    recurring host work (container assembly, segment planning, the one
    bundled d2h per batch) is inside the timed region; nothing is
    subtracted.  Returns per-volume (compress_s, decompress_s).
    """
    import jax
    import jax.numpy as jnp

    from cvxcompress_tpu import pipeline

    v0 = jax.device_put(vol)
    vd = [v0 * jnp.float32(1.0 + 1e-6 * j) for j in range(n_vols)]
    jax.block_until_ready(vd)
    # warm every compiled shape + host codepath
    datas0 = pipeline.compress_batched(vd[:batch], scale, block=block)
    jax.block_until_ready(
        pipeline.decompress_batched(datas0, to_host=False))

    t0 = time.perf_counter()
    datas = [
        d for d, _ in pipeline.compress_stream_batched(
            vd, scale, block=block, batch=batch
        )
    ]
    t_c = (time.perf_counter() - t0) / n_vols

    t0 = time.perf_counter()
    jax.block_until_ready(list(pipeline.decompress_stream_batched(
        datas, batch=batch, to_host=False
    )))
    t_d = (time.perf_counter() - t0) / n_vols
    return t_c, t_d


def bench_snapshots(vol, block, scale, n=6):
    """DeviceSnapshotStack append / reconstruct (pop) seconds per snapshot,
    on a warm stack: n appends then n pops, each phase ended by
    block_until_ready."""
    import jax

    from cvxcompress_tpu.snapshots import DeviceSnapshotStack

    store = DeviceSnapshotStack(vol.shape, scale, block=block,
                                max_pending=n + 1)
    vd = jax.device_put(vol)
    vols = [vd * (1.0 + 1e-6 * j) for j in range(n)]
    jax.block_until_ready(vols)
    store.append(vd)
    jax.block_until_ready(store.pop())  # warm

    t0 = time.perf_counter()
    for v in vols:
        store.append(v)
    store.flush()
    jax.block_until_ready(store._snaps[-1][0])
    t_app = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    last = None
    for _ in range(n):
        last = store.pop()
    jax.block_until_ready(last)
    t_pop = (time.perf_counter() - t0) / n
    return t_app, t_pop


def bench_block_sweep(budget, detail):
    """Per-block-size perf: transform fwd/inv and codec roundtrip.

    The reference publishes transform fwd+inv MCells/s for 8^3..256^3
    (README.md:35-40, harness CvxCompress.cpp:803-891); this sweep
    records the device numbers side by side, plus full codec compress /
    decompress at each size on a 256^3 sinusoid.  Budget-gated per size
    and flushed per size.
    """
    import jax
    import jax.numpy as jnp
    import jax.random as jrandom

    from cvxcompress_tpu.ops import codec as jcodec
    from cvxcompress_tpu.ops import wavelet as dw

    sweep = detail.setdefault("block_sweep", {})
    sweep["reference_fwdinv_mcells_s"] = {
        "8c": 25725, "16c": 34178, "32c": 22680, "64c": 10934,
        "128c": 2962, "256c": 6661,
    }
    vol = make_volume(256, 256, 256)
    for bs in (8, 16, 32, 64, 128, 256):
        if not budget.admit(f"sweep_{bs}c", 35):
            continue
        n = max(1, (1 << 25) // bs**3)
        sweep[f"{bs}c_cells"] = n * bs**3
        # transform throughput is data-independent: generate on device
        x = jax.jit(
            lambda k: jrandom.normal(k, (n, bs, bs, bs), jnp.float32)
        )(jrandom.PRNGKey(bs))

        entry = {}
        for tag, f in (("fwd", dw.forward_3d), ("inv", dw.inverse_3d)):
            g = jax.jit(f)
            el = window_time(lambda j: g(x), 4)[0]
            entry[f"transform_{tag}_mcells_s"] = round(n * bs**3 / el / 1e6)
        tf = entry["transform_fwd_mcells_s"]
        ti = entry["transform_inv_mcells_s"]
        entry["transform_fwdinv_mcells_s"] = round(
            2.0 / (1.0 / tf + 1.0 / ti)
        )

        block = (bs, bs, bs)
        data, _ = jcodec.compress(vol, 1e-2, block=block)
        t_c = bench_device_compress(vol, block, 1e-2, iters=3, reps=2)[0]
        t_d = bench_device_decompress(data, vol.shape, iters=3, reps=2)[0][0]
        entry["compress_mcells_s"] = round(vol.size / t_c / 1e6)
        entry["decompress_mcells_s"] = round(vol.size / t_d / 1e6)
        sweep[f"{bs}c"] = entry
        log(f"[sweep {bs:3}^3] fwd {tf} MC/s inv {ti} MC/s "
            f"compress {entry['compress_mcells_s']} "
            f"decompress {entry['decompress_mcells_s']}")
        flush_partial(detail)
    return sweep


def bench_quality(vol, block, scale):
    from cvxcompress_tpu.ops import codec as jcodec

    jcodec.compress(vol, scale, block=block)  # warm (compiles, lib loads)
    data, ratio = jcodec.compress(vol, scale, block=block)
    out = jcodec.decompress(data)
    o = vol.astype(np.float64)
    d = o - out.astype(np.float64)
    err = float(np.sqrt((d * d).mean()) / np.sqrt((o * o).mean()))
    snr = -20.0 * np.log10(err) if err > 0 else float("inf")
    return data, ratio, err, snr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--budget", type=float, default=300.0,
                    help="wall-clock budget in seconds (default 300)")
    args = ap.parse_args()

    from cvxcompress_tpu.utils import cache
    from cvxcompress_tpu.utils.profiling import card_line

    cache.enable_compile_cache()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log(f"bench: needs a GPU; JAX computes on {devices[0].platform}")
        return 2

    budget = Budget(args.budget)
    detail = {
        "budget_s": args.budget, "skipped": budget.skipped,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices)},
        "card": card_line(),
    }
    results = {}
    err_msg = None
    try:
        run_stages(args, budget, detail, results)
    except Exception as e:  # noqa: BLE001 — the JSON line must still print
        import traceback

        err_msg = f"{type(e).__name__}: {e}"
        traceback.print_exc(file=sys.stderr)

    detail["elapsed_s"] = round(budget.elapsed(), 1)
    if err_msg:
        detail["error"] = err_msg
    detail["baseline"] = {
        "reference_compress_mcells_s": BASELINE_COMPRESS,
        "reference_decompress_mcells_s": BASELINE_DECOMPRESS,
        "reference_roundtrip_mcells_s": BASELINE_ROUNDTRIP,
    }
    a = results.get("A_ref_ci_32c", {})
    c = a.get("device_compress_mcells_s")
    d = a.get("device_decompress_mcells_s")
    if c and d:
        headline = 2.0 / (1.0 / c + 1.0 / d)
    else:
        headline = 0.0
    out = {
        "metric": "device_roundtrip_320x416x352_32c_scale1e-2",
        "value": round(headline, 1),
        "unit": "MCells/s",
        "vs_baseline": round(headline / BASELINE_ROUNDTRIP, 3),
        "detail": detail,
    }
    # the sustained roundtrip WITH host work included (batched stream
    # APIs), reported next to the device-only figure
    sc = a.get("pipelined_sustained_compress_mcells_s")
    sd = a.get("pipelined_sustained_decompress_mcells_s")
    if sc and sd:
        sus = 2.0 / (1.0 / sc + 1.0 / sd)
        out["sustained_roundtrip_mcells_s"] = round(sus, 1)
        out["sustained_vs_baseline"] = round(sus / BASELINE_ROUNDTRIP, 3)
    flush_partial(detail)
    print(json.dumps(out), flush=True)
    return 1 if err_msg else 0


def run_stages(args, budget, detail, results):
    log("card:", detail["card"], "device:", detail["device"])

    # per-stage wall clock, so the budget estimates stay honest
    stage_s = detail.setdefault("stage_s", {})

    def mark(stage_name, t_start):
        stage_s[stage_name] = round(time.monotonic() - t_start, 1)

    if args.quick:
        shape_a, block_a = (160, 192, 160), (32, 32, 32)
        shape_b, block_b = (256, 256, 256), (128, 128, 128)
        iters, n_stream = 3, 4
    else:
        shape_a, block_a = (352, 416, 320), (32, 32, 32)
        shape_b, block_b = (384, 384, 384), (128, 128, 128)
        iters, n_stream = 6, 8

    scale = 1e-2
    for name, shape, block in (
        ("A_ref_ci_32c", shape_a, block_a),
        ("B_north_star_128c", shape_b, block_b),
    ):
        # the headline (device A) always runs; B is budget-gated
        if name != "A_ref_ci_32c" and not budget.admit(name, 60):
            continue
        from cvxcompress_tpu.ops import codec as jcodec

        t_stage = time.monotonic()
        vol = make_volume(*shape)
        ncells = vol.size
        data, ratio, err, snr = bench_quality(vol, block, scale)
        mark(f"{name}_quality", t_stage)
        host_asm = jcodec.last_host_assembly_s
        log(f"[{name}] ratio={ratio:.0f} err={err:.2e} snr={snr:.1f}dB")
        if name == "A_ref_ci_32c":
            # the reference CI bars, asserted on the reference CI input
            # (Test_With_Generated_Input.cpp:121-122); --quick shrinks the
            # volume, which legitimately shifts quality off the full-size
            # bars, so quick mode asserts scale-appropriate ones
            e_bar, s_bar = (4e-4, 70.0) if args.quick else (2e-4, 75.0)
            assert err < e_bar and snr > s_bar, (
                f"quality bars FAILED: err={err:.3e} snr={snr:.1f}"
            )

        t_stage = time.monotonic()
        t_c, c_lo, c_hi = bench_device_compress(vol, block, scale, iters)
        (t_d, d_lo, d_hi), t_plan = bench_device_decompress(
            data, shape, iters)
        mark(f"{name}_device", t_stage)
        dev_c = ncells / t_c / 1e6
        dev_d = ncells / t_d / 1e6
        log(f"[{name}] device compress {t_c*1e3:.2f} ms = {dev_c:.0f} MC/s "
            f"(+{host_asm*1e3:.1f} ms host assembly); "
            f"decompress {t_d*1e3:.2f} ms = {dev_d:.0f} MC/s "
            f"(+{t_plan*1e3:.1f} ms host plan)")

        results[name] = {
            "cells": int(ncells),
            "ratio": round(float(ratio), 1),
            "rel_error": float(err),
            "snr_db": round(snr, 1),
            "device_compress_mcells_s": round(dev_c, 1),
            "device_compress_ms_min_max": [c_lo * 1e3, c_hi * 1e3],
            "device_decompress_mcells_s": round(dev_d, 1),
            "device_decompress_ms_min_max": [d_lo * 1e3, d_hi * 1e3],
            "host_assembly_ms": round(host_asm * 1e3, 2),
            "host_plan_ms": round(t_plan * 1e3, 2),
        }
        detail[name] = results[name]
        flush_partial(detail)

        if budget.admit(f"{name}_sustained", 45):
            t_stage = time.monotonic()
            t_sc, t_sd = bench_sustained(
                vol, block, scale, n_vols=n_stream, batch=max(2, n_stream // 2)
            )
            sus_c, sus_d = ncells / t_sc / 1e6, ncells / t_sd / 1e6
            log(f"[{name}] sustained (host work included, {n_stream} vols, "
                f"batched stream API): compress {sus_c:.0f} MC/s, "
                f"decompress {sus_d:.0f} MC/s")
            results[name]["pipelined_sustained_compress_mcells_s"] = round(
                sus_c, 1
            )
            results[name]["pipelined_sustained_decompress_mcells_s"] = round(
                sus_d, 1
            )
            mark(f"{name}_sustained", t_stage)
            flush_partial(detail)

        if budget.admit(f"{name}_local_rms", 40):
            t_stage = time.monotonic()
            t_lc = bench_device_compress(
                vol, block, scale, iters, use_local=True
            )[0]
            loc_c = ncells / t_lc / 1e6
            log(f"[{name}] device compress LOCAL-RMS {t_lc*1e3:.2f} ms = "
                f"{loc_c:.0f} MC/s ({loc_c/dev_c:.2f}x of global)")
            results[name]["device_compress_local_rms_mcells_s"] = round(
                loc_c, 1
            )
            mark(f"{name}_local_rms", t_stage)
            flush_partial(detail)

        if budget.admit(f"{name}_snapshots", 30):
            t_stage = time.monotonic()
            t_app, t_pop = bench_snapshots(vol, block, scale, n=iters)
            snap_a, snap_p = ncells / t_app / 1e6, ncells / t_pop / 1e6
            log(f"[{name}] snapshot stack append {snap_a:.0f} MC/s, "
                f"reconstruct {snap_p:.0f} MC/s")
            results[name]["snapshot_append_mcells_s"] = round(snap_a, 1)
            results[name]["snapshot_reconstruct_mcells_s"] = round(snap_p, 1)
            mark(f"{name}_snapshots", t_stage)
            flush_partial(detail)

    if not args.quick and budget.admit("block_sweep", 40):
        t_stage = time.monotonic()
        bench_block_sweep(budget, detail)
        mark("block_sweep", t_stage)


if __name__ == "__main__":
    sys.exit(main())
