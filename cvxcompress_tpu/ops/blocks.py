"""Volume <-> block-grid layout transforms (the device Block_Copy).

The reference gathers/scatters strided blocks with SSE copies
(Block_Copy.cpp:21-116 gather with zero-padding of partial edge blocks,
:136-212 clipped scatter).  On the device this is a layout problem, not a copy
problem: pad once, reshape/transpose into a (nnn, bz, by, bx) block batch
that every downstream kernel consumes, and invert at the end.

Block index order matches the reference raster order: x fastest, then y,
then z (CvxCompress.cpp:321-328), i.e. C-order over (nbz, nby, nbx).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def grid_shape(vol_shape, block):
    (nz, ny, nx), (bx, by, bz) = vol_shape, block
    return (-(-nz // bz), -(-ny // by), -(-nx // bx))


def to_blocks(vol, block):
    """(nz, ny, nx) volume -> (nnn, bz, by, bx) zero-padded block batch.

    Zero padding of partial edge blocks matches Copy_To_Block
    (Block_Copy.cpp:98-115).
    """
    bx, by, bz = block
    nz, ny, nx = vol.shape
    nbz, nby, nbx = grid_shape(vol.shape, block)
    pz, py, px = nbz * bz - nz, nby * by - ny, nbx * bx - nx
    v = jnp.pad(vol, ((0, pz), (0, py), (0, px)))
    v = v.reshape(nbz, bz, nby, by, nbx, bx)
    v = v.transpose(0, 2, 4, 1, 3, 5)  # (nbz, nby, nbx, bz, by, bx)
    return v.reshape(nbz * nby * nbx, bz, by, bx)


def from_blocks(blocks, vol_shape, block):
    """(nnn, bz, by, bx) block batch -> (nz, ny, nx) volume (clipped).

    Clipping at volume edges matches Copy_From_Block (Block_Copy.cpp:152-206).
    """
    bx, by, bz = block
    nz, ny, nx = vol_shape
    nbz, nby, nbx = grid_shape(vol_shape, block)
    v = blocks.reshape(nbz, nby, nbx, bz, by, bx)
    v = v.transpose(0, 3, 1, 4, 2, 5)  # (nbz, bz, nby, by, nbx, bx)
    v = v.reshape(nbz * bz, nby * by, nbx * bx)
    return v[:nz, :ny, :nx]


def block_origin(ib, vol_shape, block):
    """Block index -> (x0, y0, z0) origin (CvxCompress.cpp:321-328)."""
    bx, by, bz = block
    nbz, nby, nbx = grid_shape(vol_shape, block)
    iiz, r = divmod(int(ib), nbx * nby)
    iiy, iix = divmod(r, nbx)
    return iix * bx, iiy * by, iiz * bz


def to_blocks_np(vol, block):
    """NumPy twin of to_blocks (host-side paths)."""
    bx, by, bz = block
    nz, ny, nx = vol.shape
    nbz, nby, nbx = grid_shape(vol.shape, block)
    pz, py, px = nbz * bz - nz, nby * by - ny, nbx * bx - nx
    v = np.pad(vol, ((0, pz), (0, py), (0, px)))
    v = v.reshape(nbz, bz, nby, by, nbx, bx).transpose(0, 2, 4, 1, 3, 5)
    return np.ascontiguousarray(v.reshape(nbz * nby * nbx, bz, by, bx))


def from_blocks_np(blocks, vol_shape, block):
    """NumPy twin of from_blocks."""
    bx, by, bz = block
    nz, ny, nx = vol_shape
    nbz, nby, nbx = grid_shape(vol_shape, block)
    v = blocks.reshape(nbz, nby, nbx, bz, by, bx).transpose(0, 3, 1, 4, 2, 5)
    v = v.reshape(nbz * bz, nby * by, nbx * bx)
    return np.ascontiguousarray(v[:nz, :ny, :nx])
