"""3D wavelet transform: the multi-level cascade as matrix products.

NOT a port of the reference's AVX lifting kernels
(Wavelet_Transform_Fast.cpp / the generated Ds79/Us79 bodies): the full
multi-level 1D transform along an axis is a *linear operator*, so we
precompute one dense n x n matrix per axis length (composed in float64 from
the per-level analysis/synthesis operators defined by the oracle's mirror
rules, Wavelet_Transform_Slow.cpp:71-134,201-259) and apply the 3D transform
as three batched tensor contractions.  Thousands of independent blocks batch
into large matrix products instead of scalar lifting loops.

Accuracy: operators are composed in float64 and applied in a single float32
contraction at FLOAT_PREC; agreement with the scalar oracle cascade is
~1e-6 relative, well inside the 1e-5 bar the reference itself uses
between its own slow and fast paths (CvxCompress.cpp:597).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import wavelet as ow

# Precision of every float wavelet contraction.  It must hold the 1e-5
# relative transform contract against the oracle (CvxCompress.cpp:597) on
# the device: measured on an H100, HIGH (TF32 inputs) misses it and
# HIGHEST meets it (PERF.md, findings; tools/precision_check.py).
FLOAT_PREC = jax.lax.Precision.HIGHEST


def _level_matrix_forward(n):
    """Single-level n x n analysis operator (float64).

    Rows = outputs in [L | H] layout; taps and mirrored columns follow
    Ds79 (Wavelet_Transform_Slow.cpp:95-124).
    """
    al = ow.AL.astype(np.float64)
    ah = ow.AH.astype(np.float64)
    m = np.zeros((n, n), dtype=np.float64)
    nh = n // 2
    nl = n - nh
    for ix in range(nl):
        i0 = 2 * ix
        m[ix, i0] += al[0]
        for off in (1, 2, 3, 4):
            m[ix, ow.mirr(i0 - off, n)] += al[off]
            m[ix, ow.mirr(i0 + off, n)] += al[off]
    for ix in range(nh):
        i0 = 2 * ix + 1
        m[nl + ix, i0] += ah[0]
        for off in (1, 2, 3):
            m[nl + ix, ow.mirr(i0 - off, n)] += ah[off]
            m[nl + ix, ow.mirr(i0 + off, n)] += ah[off]
    return m


def _level_matrix_inverse(n):
    """Single-level n x n synthesis operator (float64).

    Us79 (Wavelet_Transform_Slow.cpp:230-248) with the band-local mirrors
    MIRR_SL / MIRR_SH.
    """
    sl = ow.SL.astype(np.float64)
    sh = ow.SH.astype(np.float64)
    m = np.zeros((n, n), dtype=np.float64)
    nh = n // 2
    nl = n - nh
    for k in range(nl):
        m[2 * k, k] += sl[0]
        m[2 * k, ow.mirr_sl(k - 1, nl)] += sl[2]
        m[2 * k, ow.mirr_sl(k + 1, nl)] += sl[2]
        m[2 * k, ow.mirr_sh(nl + k - 1, nl, nh)] += sh[1]
        m[2 * k, ow.mirr_sh(nl + k, nl, nh)] += sh[1]
        m[2 * k, ow.mirr_sh(nl + k - 2, nl, nh)] += sh[3]
        m[2 * k, ow.mirr_sh(nl + k + 1, nl, nh)] += sh[3]
    for k in range(nh):
        m[2 * k + 1, ow.mirr_sl(k, nl)] += sl[1]
        m[2 * k + 1, ow.mirr_sl(k + 1, nl)] += sl[1]
        m[2 * k + 1, ow.mirr_sl(k - 1, nl)] += sl[3]
        m[2 * k + 1, ow.mirr_sl(k + 2, nl)] += sl[3]
        m[2 * k + 1, nl + k] += sh[0]
        m[2 * k + 1, ow.mirr_sh(nl + k - 1, nl, nh)] += sh[2]
        m[2 * k + 1, ow.mirr_sh(nl + k + 1, nl, nh)] += sh[2]
        m[2 * k + 1, ow.mirr_sh(nl + k - 2, nl, nh)] += sh[4]
        m[2 * k + 1, ow.mirr_sh(nl + k + 2, nl, nh)] += sh[4]
    return m


@functools.lru_cache(maxsize=None)
def forward_matrix(dim):
    """Composed multi-level analysis operator W_dim (float64 ndarray).

    W = prod over the level schedule (dim, dim-dim//2, ..., 2) of the
    level operator extended with identity on the already-finished suffix
    (Wavelet_Transform_Slow.cpp:80).
    """
    w = np.eye(dim, dtype=np.float64)
    for n in ow.level_schedule(dim):
        m = np.eye(dim, dtype=np.float64)
        m[:n, :n] = _level_matrix_forward(n)
        w = m @ w
    return w


@functools.lru_cache(maxsize=None)
def inverse_matrix(dim):
    """Composed multi-level synthesis operator W^-1_dim (float64 ndarray)."""
    w = np.eye(dim, dtype=np.float64)
    for n in reversed(ow.level_schedule(dim)):
        m = np.eye(dim, dtype=np.float64)
        m[:n, :n] = _level_matrix_inverse(n)
        w = m @ w
    return w


def _f32(m):
    return jnp.asarray(np.asarray(m, dtype=np.float32))


def forward_3d(blocks):
    """Forward transform of a (..., bz, by, bx) block batch.

    Three contractions (x, then y, then z — the reference's axis order,
    Wavelet_Transform_Slow.cpp:275-279); each is a batched matmul with
    float32 accumulation.
    """
    bz, by, bx = blocks.shape[-3:]
    hi = FLOAT_PREC
    out = blocks
    if bx > 1:
        out = jnp.einsum("...zyx,Xx->...zyX", out, _f32(forward_matrix(bx)),
                         precision=hi, preferred_element_type=jnp.float32)
    if by > 1:
        out = jnp.einsum("...zyx,Yy->...zYx", out, _f32(forward_matrix(by)),
                         precision=hi, preferred_element_type=jnp.float32)
    if bz > 1:
        out = jnp.einsum("...zyx,Zz->...Zyx", out, _f32(forward_matrix(bz)),
                         precision=hi, preferred_element_type=jnp.float32)
    return out


def inverse_3d(blocks):
    """Inverse transform of a (..., bz, by, bx) coefficient batch."""
    bz, by, bx = blocks.shape[-3:]
    hi = FLOAT_PREC
    out = blocks
    if bx > 1:
        out = jnp.einsum("...zyx,Xx->...zyX", out, _f32(inverse_matrix(bx)),
                         precision=hi, preferred_element_type=jnp.float32)
    if by > 1:
        out = jnp.einsum("...zyx,Yy->...zYx", out, _f32(inverse_matrix(by)),
                         precision=hi, preferred_element_type=jnp.float32)
    if bz > 1:
        out = jnp.einsum("...zyx,Zz->...Zyx", out, _f32(inverse_matrix(bz)),
                         precision=hi, preferred_element_type=jnp.float32)
    return out


def forward_3d_blocked(vol, vol_shape3, block):
    """Padded volume -> (nnn, bz, by, bx) transformed blocks, fused layout.

    Applies the per-axis contractions in VOLUME order (all reshapes are
    free row-major splits) and folds the block-major permutation into the
    final einsum's output indexing: bit-identical to transform-after-
    to_blocks (the contraction order per axis is unchanged) with one
    fewer full-size relayout.
    """
    nz, ny, nx = vol_shape3
    bx, by, bz = block
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    hi = FLOAT_PREC
    pz, py, px = nbz * bz - nz, nby * by - ny, nbx * bx - nx
    a = jnp.pad(vol, ((0, pz), (0, py), (0, px)))
    if bx > 1:
        a = a.reshape(nbz * bz, nby * by, nbx, bx)
        a = jnp.einsum("zybx,Xx->zybX", a, _f32(forward_matrix(bx)),
                       precision=hi, preferred_element_type=jnp.float32)
    if by > 1:
        a = a.reshape(nbz * bz, nby, by, nbx, bx)
        a = jnp.einsum("zgybx,Yy->zgYbx", a, _f32(forward_matrix(by)),
                       precision=hi, preferred_element_type=jnp.float32)
    a = a.reshape(nbz, bz, nby, by, nbx, bx)
    if bz > 1:
        # contraction + block-major output permutation in one einsum
        a = jnp.einsum("hzgybx,Zz->hgbZyx", a, _f32(forward_matrix(bz)),
                       precision=hi, preferred_element_type=jnp.float32)
    else:
        a = a.transpose(0, 2, 4, 1, 3, 5)
    return a.reshape(nbz * nby * nbx, bz, by, bx)


@functools.lru_cache(maxsize=None)
def _blockdiag(dim, width, inverse):
    """(width, width) block-diagonal operator (float32 ndarray): width//dim
    copies of the dim-axis operator, so the x contraction runs at full
    row width (K=N=width) instead of on (.., dim)-minor rows.
    """
    m = inverse_matrix(dim) if inverse else forward_matrix(dim)
    k = width // dim
    bd = np.zeros((width, width), dtype=np.float64)
    for i in range(k):
        bd[i * dim : (i + 1) * dim, i * dim : (i + 1) * dim] = m
    return np.asarray(bd, dtype=np.float32)


def apply_x_rows(rows, bx, inverse=True):
    """x-axis transform on (N, width) rows; width must be a multiple of
    max(bx, 128) or of bx when bx >= 128.

    Rows are viewed as (N*width/w, w) with w = max(bx, 128) — a free
    row-major split keeping the matmul 128 wide — and hit with the
    block-diagonal operator.
    """
    if bx <= 1:
        return rows
    width = rows.shape[-1]
    w = max(bx, 128) if width % max(bx, 128) == 0 else bx
    r2 = rows.reshape(-1, w)
    out = jnp.einsum(
        "rc,Cc->rC", r2, jnp.asarray(_blockdiag(bx, w, inverse)),
        precision=FLOAT_PREC,
        preferred_element_type=jnp.float32,
    )
    return out.reshape(rows.shape)


def apply_x_inverse_rows(rows, bx):
    return apply_x_rows(rows, bx, inverse=True)


def forward_3d_volume(vol, vol_shape3, block):
    """Forward transform in VOLUME order: the padded (nzp*nyp, nxp2) plane.

    No block-major permutation anywhere — x (block-diagonal, full row
    width), then y, then z contractions applied in place (the reference's
    axis order, Wavelet_Transform_Slow.cpp:275-279).  The plane has the
    decode plane's layout, with all-zero x-blocks up to padded_nbx
    (phantom block columns that downstream stages drop).
    """
    nz, ny, nx = vol_shape3
    bx, by, bz = block
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    nbx = padded_nbx(nbx, bx)
    nzp, nyp, nxp = nbz * bz, nby * by, nbx * bx
    hi = FLOAT_PREC
    a = jnp.pad(vol, ((0, nzp - nz), (0, nyp - ny), (0, nxp - nx)))
    a = a.reshape(nzp * nyp, nxp)
    a = apply_x_rows(a, bx, inverse=False)
    if by > 1:
        a = a.reshape(nzp, nby, by, nxp)
        a = jnp.einsum("zgyx,Yy->zgYx", a, _f32(forward_matrix(by)),
                       precision=hi, preferred_element_type=jnp.float32)
    if bz > 1:
        a = a.reshape(nbz, bz, nyp * nxp)
        a = jnp.einsum("hzr,Zz->hZr", a, _f32(forward_matrix(bz)),
                       precision=hi, preferred_element_type=jnp.float32)
    return a.reshape(nzp * nyp, nxp)


def padded_nbx(nbx, bx):
    """x-block count rounded up so the padded x extent is a multiple of 128.

    The volume-order planes (decode, snapshots) use this width so every x
    contraction runs on 128-wide rows (bx >= 128 is already aligned).
    """
    k = max(1, 128 // bx) if bx < 128 else 1
    return -(-nbx // k) * k


def inverse_3d_volume(rows, vol_shape3, block):
    """Inverse transform of VOLUME-ORDER coefficient rows (x already done).

    `rows` is (nzp*nyp, nxp2) float32 in padded volume order — nxp2 may
    carry extra all-zero x-blocks for alignment (padded_nbx) — whose
    x-axis inverse has ALREADY been applied (linearity lets the per-row
    operator commute with the expand; zero padding stays zero).  Applies
    the y and z contractions in volume order — no block-major permutation
    anywhere — and clips the padding.  Same operators, same x->y->z order
    as inverse_3d (Wavelet_Transform_Slow.cpp:296-300).
    """
    nz, ny, nx = vol_shape3
    bx, by, bz = block
    nbz, nby = -(-nz // bz), -(-ny // by)
    nzp, nyp = nbz * bz, nby * by
    nxp2 = rows.shape[-1]
    hi = FLOAT_PREC
    a = rows
    if by > 1:
        a = a.reshape(nzp, nby, by, nxp2)
        a = jnp.einsum("zgyx,Yy->zgYx", a, _f32(inverse_matrix(by)),
                       precision=hi, preferred_element_type=jnp.float32)
    if bz > 1:
        a = a.reshape(nbz, bz, nyp * nxp2)
        a = jnp.einsum("hzr,Zz->hZr", a, _f32(inverse_matrix(bz)),
                       precision=hi, preferred_element_type=jnp.float32)
    return a.reshape(nzp, nyp, nxp2)[:nz, :ny, :nx]


def flops_per_cell(block):
    """Analytic FLOP count per cell for the matmul formulation.

    (The reference's lifting-FLOP model is CvxCompress.cpp:663-671; the
    dense-operator formulation trades ~4x more FLOPs for matrix-unit
    execution.)
    """
    bx, by, bz = block
    return 2 * (bx * (bx > 1) + by * (by > 1) + bz * (bz > 1))
