"""NumPy oracle codec: the correctness and format authority.

Mirrors the reference semantics (see module docstrings for file:line cites)
with trivially-auditable NumPy code.  The device path is tested against this
package — the wavelet transform to float tolerance, the entropy stage
bit-for-bit.
"""

from . import codec, rle, wavelet  # noqa: F401
from .codec import compress, decompress  # noqa: F401
