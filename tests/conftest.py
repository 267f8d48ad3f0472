"""Test configuration.

Unit tests run on the CPU with a virtual 8-device mesh so multi-device
sharding is exercised without GPUs (`python chip_smoke.py` runs the main
path on the GPU; `--sharded` runs the mesh on four).
"""

import os

# force CPU: unit tests exercise the virtual 8-device mesh
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from cvxcompress_tpu.utils import cache  # noqa: E402

# persistent compilation cache: the decoder/codec programs are large and
# dominate CPU suite time on repeat runs
cache.enable_compile_cache()

import contextlib  # noqa: E402
import fcntl  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@contextlib.contextmanager
def file_lock(name):
    """Cross-process build lock (the suite runs under pytest-xdist: two
    workers must not compile into the same /tmp build tree at once)."""
    path = os.path.join(tempfile.gettempdir(), f"{name}.lock")
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


_TEST_COUNT = [0]


@pytest.fixture(autouse=True)
def _periodic_cache_clear():
    """XLA:CPU has segfaulted inside its compile/cache machinery after
    ~250 tests' worth of compilations accumulate in ONE process
    (backend_compile_and_load).  pytest-xdist keeps each worker below the
    threshold; for single-process runs, dropping the live-executable
    population every 60 tests keeps the process under it too.  The
    persistent on-disk cache makes the re-compiles cheap."""
    yield
    _TEST_COUNT[0] += 1
    if _TEST_COUNT[0] % 60 == 0:
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def make_sinusoid_volume(nz, ny, nx, periods=10):
    """Constant-x-slice sinusoid volume (Test_With_Generated_Input.cpp:45-51).

    Values vary along the slow (z) axis only: vol[z,y,x] = sin(z*pi*periods/nz).
    """
    z = np.sin(np.arange(nz) * np.pi * periods / nz).astype(np.float32)
    return np.broadcast_to(z[:, None, None], (nz, ny, nx)).copy()


def make_radial_volume(nz=51, ny=101, nx=151, noise=True, seed=7):
    """Radial sinusoid volume + noise (Read_Raw_Volume.cpp:28-42)."""
    z0, y0, x0 = (nz - 1) // 2, (ny - 1) // 2, (nx - 1) // 2
    zz = (np.arange(nz) - z0)[:, None, None]
    yy = (np.arange(ny) - y0)[None, :, None]
    xx = (np.arange(nx) - x0)[None, None, :]
    r = np.sqrt(zz * zz + yy * yy + xx * xx)
    vol = np.sin(r / 10.0)
    if noise:
        vol = vol + np.random.default_rng(seed).random(vol.shape) / 100.0
    return vol.astype(np.float32)


def rel_error_and_snr(orig, recon):
    """Relative RMS error and SNR in dB (Test_With_Generated_Input.cpp:98-115)."""
    o = np.asarray(orig, dtype=np.float64)
    d = o - np.asarray(recon, dtype=np.float64)
    rms_in = np.sqrt(np.mean(o * o))
    rms_df = np.sqrt(np.mean(d * d))
    err = rms_df / rms_in
    snr = -20.0 * np.log10(err) if err > 0 else np.inf
    return err, snr
