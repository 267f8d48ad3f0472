"""chip_smoke.py on the CPU: its contract without a GPU, its last line, and
its phases at small sizes (`python chip_smoke.py` runs them at the
reference's sizes on the GPU)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from cvxcompress_tpu.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(args, where):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=where, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [[], ["--sharded"]])
def test_exits_nonzero_without_gpu(args):
    r = run_smoke(args, ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""  # no result line
    assert "needs a GPU" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = run_smoke([], tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


class FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_result_line(count):
    line = cs.result_line([FakeDevice()] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": count},
    }


def test_card_line(monkeypatch):
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        return subprocess.CompletedProcess(
            cmd, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")

    monkeypatch.setattr(profiling.subprocess, "run", fake_run)
    assert cs.card_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen == [["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]]


def test_card_line_fails_without_nvidia_smi(monkeypatch):
    def fake_run(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(profiling.subprocess, "run", fake_run)
    with pytest.raises(FileNotFoundError):
        cs.card_line()


@pytest.mark.parametrize("k", [0, 5])
def test_gain_volumes_quantize_like_the_ci_input(k):
    """A volume scaled by gain(k, n) decodes to exactly gain(k, n) times
    the CI input's decode, so it meets the same bars."""
    import cvxcompress_tpu as cvx

    shape, block = (64, 32, 32), (16, 16, 16)
    g = cs.gain(k, 8)
    assert abs(g) == 2.0 ** (k - 4) and (g < 0) == (k % 2 == 1)
    a, _ = cvx.compress(cs.sinusoid(shape, periods=3), 1e-2, block=block)
    b, _ = cvx.compress(cs.sinusoid(shape, periods=3, gain=g), 1e-2,
                        block=block)
    assert a.size == b.size
    out_a = cvx.decompress(a) * np.float32(g)
    np.testing.assert_array_equal(cvx.decompress(b), out_a)


def test_phase_ci_small():
    ratio, t = cs.phase_ci(shape=(96, 64, 64), periods=3, reps=1)
    assert ratio > 500
    assert set(t) == {"compress", "decompress[device engine]",
                      "decompress[host engine]"}


def test_phase_big_small():
    t = cs.phase_big(shape=(128, 128, 128), block=(64, 64, 64), periods=3,
                     reps=1)
    assert len(t) == 4


def test_phase_radial_small():
    t = cs.phase_radial(shape=(96, 64, 64), sample=8, reps=1)
    assert len(t) == 2


def test_phase_stream_small():
    t = cs.phase_stream(shape=(96, 64, 64), periods=3, n=3, batch=2)
    assert all(v[0] > 0 for v in t.values())


def test_phase_snapshots_small():
    t = cs.phase_snapshots(shape=(96, 64, 64), periods=3, n=4)
    assert all(v[0] > 0 for v in t.values())


def test_phase_sharded_small():
    """The 4-device phase on four virtual CPU devices."""
    cs.phase_sharded(
        jax.devices()[:4],
        cases=(((96, 64, 64), (32, 32, 32)), ((128, 128, 128), (64, 64, 64))),
        reps=1,
    )
