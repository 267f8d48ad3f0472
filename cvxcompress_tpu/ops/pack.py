"""Stream compaction primitives: monotone log-shift packing.

All variable-length packing in this framework uses ONE primitive that
needs only whole-array shifts and selects (no data-dependent element
gather or scatter):

    monotone log-shift compaction
    -----------------------------
    Live elements whose move-left distances are non-decreasing in position
    can be packed to the front in ceil(log2(max_dist)) rounds.  Round k
    moves every live element whose remaining distance has bit k set by
    2^k slots left (LSB->MSB).  Monotonicity guarantees no two live
    elements ever collide (distances stay non-decreasing and mutually
    ordered: for i<j with rem_j >= rem_i, both multiples of 2^k, clearing
    bit k preserves rem_j' >= rem_i'); slots vacated without replacement
    are marked dead so stale copies can never overwrite live data.

Compaction (front-packing) always has monotone distances: the distance of
live element at position p is p - rank(p), and rank increments by at most 1
per slot.  This is the data-parallel replacement for the reference's
sequential byte cursor (Run_Length_Encode_Slow.cpp:189-294) and its
omp-critical stream packing (CvxCompress.cpp:370-374).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

I32 = jnp.int32


def ceil_log2(n):
    return max(1, int(np.ceil(np.log2(max(int(n), 2)))))


def _shl_rows(x, s, fill):
    """Shift rows left by s along the last axis, filling with `fill`."""
    pad_shape = x.shape[:-1] + (s,)
    pad = jnp.full(pad_shape, fill, dtype=x.dtype)
    if s >= x.shape[-1]:
        return pad[..., : x.shape[-1]]
    return jnp.concatenate([x[..., s:], pad], axis=-1)


def compact_rows(values, dist, rounds):
    """Pack live elements of each row to the row front.

    values: one array or a tuple of arrays, shape (..., L), moved together.
    dist:   (..., L) int32; move-left distance for live elements,
            -1 for dead elements.  Distances must be non-decreasing over
            the live elements of each row and < 2**rounds.
    Returns (values_packed, dist) with the first rank(row) slots of each
    row holding the live elements in order; trailing slots hold garbage.
    """
    single = not isinstance(values, (tuple, list))
    vals = [values] if single else list(values)
    for k in range(rounds):
        s = 1 << k
        inc_d = _shl_rows(dist, s, -1)
        take = (inc_d >= 0) & ((inc_d & s) != 0)
        moveout = (dist >= 0) & ((dist & s) != 0)
        vals = [jnp.where(take, _shl_rows(v, s, 0), v) for v in vals]
        dist = jnp.where(take, inc_d - s, jnp.where(moveout, -1, dist))
    return (vals[0] if single else tuple(vals)), dist


def dist_from_live(live):
    """Move-left distances for front-packing: p - rank(p); -1 when dead.

    live: (..., L) bool.  Also returns the per-row live count.
    """
    cum = jnp.cumsum(live.astype(I32), axis=-1)
    pos = jnp.arange(live.shape[-1], dtype=I32)
    dist = jnp.where(live, pos - (cum - 1), -1)
    return dist, cum[..., -1]


def compact_live(values, live, rounds=None):
    """Front-pack live elements of each row (values may be a tuple).

    Returns (packed_values, count) where count is the per-row live count.
    """
    dist, count = dist_from_live(live)
    if rounds is None:
        rounds = ceil_log2(live.shape[-1])
    packed, _ = compact_rows(values, dist, rounds)
    return packed, count
