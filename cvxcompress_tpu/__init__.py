"""cvxcompress_tpu: lossy compression of 3D seismic wavefields on the GPU.

A from-scratch JAX/XLA rebuild of the capabilities of
ChevronETC/CvxCompress: blocked multi-level Antonini 7/9 3D wavelet
transform, RMS-relative scalar quantization (global or per-block), and a
run-length + escape-code entropy stage emitting the reference-compatible
container format.

Public API (shaped by CvxCompress.hxx:19-135):

    compress(vol, scale, block=(bx,by,bz), use_local_rms=False)
        -> (container uint8 ndarray, ratio)
    decompress(container) -> (nz, ny, nx) float32 volume
    CvxCompress  -- class mirroring the reference API surface
"""

__version__ = "0.1.0"

from . import container  # noqa: F401
from .api import CvxCompress, compress, decompress  # noqa: F401
from .snapshots import DeviceSnapshotStack  # noqa: F401
