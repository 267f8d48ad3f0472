"""Public API, shaped by the reference's class CvxCompress (CvxCompress.hxx:19-135).

Three backends:
  - "jax":    the device path (batched matmul wavelet transform,
              vectorized scan-based entropy coder) — the default.
  - "native": the multithreaded C++ host codec (native/libcvxhost.so), also
              exposed as a reference-compatible C ABI for FFI consumers.
  - "oracle": the NumPy reference-semantics codec (format authority).

Both emit the identical container format; the entropy stage is bit-exact
between backends.
"""

from __future__ import annotations

import numpy as np

from . import container as ctn

DEFAULT_BACKEND = "jax"


def compress(vol, scale, block=(32, 32, 32), use_local_rms=False, backend=DEFAULT_BACKEND):
    """Compress a (nz, ny, nx) float32 volume.

    Returns (container uint8 ndarray, compression ratio).  Mirrors
    CvxCompress::Compress (CvxCompress.hxx:32-94): `scale` is the relative
    quantization scale, `block` the power-of-two block dims (bz may be 1 for
    2D volumes), `use_local_rms` switches to per-block RMS quantization.
    """
    if backend == "oracle":
        from .oracle import codec as impl

        return impl.compress(vol, scale, block=block, use_local_rms=use_local_rms)
    elif backend == "jax":
        from .ops import codec as impl

        return impl.compress(vol, scale, block=block, use_local_rms=use_local_rms)
    elif backend == "native":
        from .ops import rle_host

        return rle_host.host_compress(
            vol, scale, block=block, use_local_rms=use_local_rms
        )
    raise ValueError(f"unknown backend {backend!r}")


def decompress(data, backend=DEFAULT_BACKEND):
    """Decompress a container to a (nz, ny, nx) float32 volume.

    Accepts containers produced by either backend or by the reference
    library (offset-table driven, payload order independent).
    """
    if backend == "oracle":
        from .oracle import codec as impl

        return impl.decompress(data)
    elif backend == "jax":
        from .ops import codec as impl

        return impl.decompress(data)
    elif backend == "native":
        from .ops import rle_host

        return rle_host.host_decompress(data)
    raise ValueError(f"unknown backend {backend!r}")


class CvxCompress:
    """Drop-in style class mirroring the reference API surface.

    Reference: CvxCompress.hxx:19-135.  The thread-count parameters of the
    reference overloads have no device equivalent and are accepted/ignored.
    """

    @staticmethod
    def Min_BX():
        return ctn.MIN_B

    @staticmethod
    def Max_BX():
        return ctn.MAX_B

    Min_BY = Min_BX
    Max_BY = Max_BX
    Min_BZ = Min_BX
    Max_BZ = Max_BX

    @staticmethod
    def Is_Valid_Block_Size(bx, by, bz):
        return ctn.is_valid_block_size(bx, by, bz)

    def __init__(self, backend=DEFAULT_BACKEND):
        self.backend = backend

    def Compress(self, scale, vol, bx, by, bz, use_local_RMS=False, num_threads=None):
        """Returns (container, ratio). `num_threads` accepted for parity, unused."""
        del num_threads
        data, ratio = compress(
            vol, scale, block=(bx, by, bz), use_local_rms=use_local_RMS,
            backend=self.backend,
        )
        return data, ratio

    def Decompress(self, compressed, num_threads=None):
        """Out-of-place decompress; returns the volume (CvxCompress.hxx:97-122)."""
        del num_threads
        return decompress(compressed, backend=self.backend)

    def Decompress_Inplace(self, vol, compressed, num_threads=None):
        """In-place decompress into a caller-provided (nz, ny, nx) array.

        Mirrors cvx_decompress_inplace (CvxCompress.hxx:160-167); the
        caller's array shape must match the container header.
        """
        del num_threads
        out = decompress(compressed, backend=self.backend)
        if vol.shape != out.shape:
            raise ValueError(
                f"volume shape {vol.shape} != container {out.shape}"
            )
        np.copyto(vol, out)
        return vol

    @staticmethod
    def Run_Module_Tests(verbose=False, exhaustive=False):
        """Run the test suite (reference: CvxCompress.hxx:133).

        Runs pytest; `exhaustive` additionally runs the staged module tests
        (tools/module_tests.py) with the full 8..256 block-shape sweep,
        mirroring the reference's exhaustive switch (CvxCompress.cpp:695).
        """
        import os
        import subprocess
        import sys

        args = [sys.executable, "-m", "pytest", "tests/", "-x", "-q"]
        if verbose:
            args.remove("-q")
            args.append("-v")
        ok = subprocess.call(args) == 0
        if ok and exhaustive:
            mt = os.path.join(
                os.path.dirname(__file__), "..", "tools", "module_tests.py"
            )
            if os.path.exists(mt):
                ok = subprocess.call([sys.executable, mt, "--exhaustive"]) == 0
        return ok


def to_bytes(data) -> bytes:
    """Container ndarray -> bytes (for file IO)."""
    return np.asarray(data, dtype=np.uint8).tobytes()
