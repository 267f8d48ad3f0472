"""Device mesh helpers for the block-data-parallel codec.

The codec's only distribution axis is the block grid (blocks are fully
independent once the scalar mulfac is known — the reference exploits the
same property with OpenMP dynamic scheduling, CvxCompress.cpp:318).  Here
it is a flat 1D mesh over all devices with blocks sharded along it (the
GPUs of one host reach each other all to all over NVLink, so the mesh
follows the algorithm alone); the two global couplings are (1) the RMS
reduction (a psum) and (2) the payload offset table (prefix sum over
per-block sizes — deterministic, no critical section).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_mesh(devices=None):
    """1D mesh over the given (or all) devices, axis name 'blocks'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def block_sharding(mesh, ndim=4):
    """Sharding that splits a block batch along axis 0."""
    return NamedSharding(mesh, P(BLOCK_AXIS, *([None] * (ndim - 1))))


def replicated(mesh):
    return NamedSharding(mesh, P())


def pad_to_shards(n, n_shards):
    """Blocks to add so the batch divides evenly across shards."""
    return (-n) % n_shards
