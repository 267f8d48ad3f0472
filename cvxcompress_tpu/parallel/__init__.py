"""Multi-device parallel layer: mesh helpers and sharded compress/decompress."""

from . import compress, mesh  # noqa: F401
