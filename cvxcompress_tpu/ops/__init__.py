"""Device compute ops: block layout, matmul wavelet, quantization, entropy coding."""

from . import blocks, quant, rle_device, wavelet  # noqa: F401
