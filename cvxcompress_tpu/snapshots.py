"""Device-resident snapshot store: compressed wavefields that never leave
device memory.

The reference codec's production use is RTM: the forward pass compresses a
wavefield snapshot per timestep to host memory/disk, the backward pass
decompresses them in reverse order.  The wavefield already lives in device
memory, and the host link is the slowest path in the system — so this
store keeps the compressed snapshots ON THE DEVICE:

    store = DeviceSnapshotStack(vol_shape, scale, block=(32, 32, 32))
    for step in range(T):
        u = propagate(u)
        store.append(u)            # device-only: wavelet + quantize + sparsify
    ...
    for step in reversed(range(T)):
        u_hat = store.get(step)    # device-only: expand + inverse wavelet

Representation per snapshot: the SCALED INTEGER wavelet coefficients
(float(trunc(mulfac*c)), exact for every reachable value) in sparse row
form — only rows containing a surviving coefficient are stored ((active,
W) f32 rows plus an (nrows,) int32 inverse map).  A row is one (z, y) row
of the x-padded VOLUME-ORDER coefficient plane (width W = nbx2*bx, the
decode plane's layout), so reconstruction is ONE wide row gather straight
into the codec's shared inverse (codec._inverse_from_plane).

Reconstruction uses the byte-stream codec's dequantization (i * (1/mulfac),
Run_Length_Encode_Slow.cpp:392); the same transform and the same truncating
quantizer, except that the stack's mulfac comes from a float32 device
sum-of-squares rather than the codec's host-f64 reduction, so the two can
differ by ~1 ulp of RMS (quantizer-step-level output differences).  What is
traded away is the entropy stage's final ~2-4x byte packing, in exchange
for zero host traffic.

`to_container(i)` / `from_container(data)` convert to/from the portable
byte-stream container (through the host).  Because the stored values are
the exact scaled integers, `to_container` re-encodes losslessly: decoding
its output reproduces the snapshot reconstruction bit-for-bit.

Memory: snapshots are bucketed (quarter-step active-row capacities) so a
steady-state RTM loop reuses compiled programs and allocation sizes.
Appends dispatch speculatively against the last-known bucket; the
active-row count is fetched ASYNCHRONOUSLY and validated within at most
`max_pending` (default 2) appends, so the stack retains O(max_pending)
dense volumes of device memory for the rare capacity-overflow retry — not
O(T).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import container as ctn
from .ops import quant, rle_device, wavelet

F32 = np.float32


@functools.partial(jax.jit, static_argnames=("acap",))
def _snap_sparsify(fiv, mask, ranks, acap):
    """Compact the active rows to (acap, W) + (nrows,) invmap."""
    nrows = fiv.shape[0]
    from .ops import pack

    cidx = jnp.arange(nrows, dtype=jnp.int32)
    (aidx,), count = pack.compact_live((cidx,), mask, pack.ceil_log2(nrows))
    aidx = jnp.where(jnp.arange(nrows, dtype=jnp.int32) < count, aidx, 0)
    aidx = (
        aidx[:acap]
        if acap <= nrows
        else jnp.concatenate(
            [aidx, jnp.zeros((acap - nrows,), jnp.int32)]
        )
    )
    payload = jnp.take(fiv, aidx, axis=0)
    invmap = jnp.where(mask, ranks, acap).astype(jnp.int32)
    return payload, invmap


@functools.partial(jax.jit, static_argnames=("block",))
def _snap_encode(vol, scale, block):
    """vol -> (fiv plane rows (R, W) f32, mask, ranks, acount, mulfac).

    fiv = float(trunc(mulfac*coeff)): the scaled-integer representation
    (exact — every int32 produced by the truncating quantizer of a float32
    product is exactly representable as float32), with the identical
    truncating quantizer as the byte codec.  The global-RMS mulfac is
    computed in the same jit (no host round trip per append)."""
    ss = jnp.sum(jnp.square(vol.astype(jnp.float32)))
    rms = jnp.sqrt(ss / vol.size)
    glob_mulfac = quant.mulfac_from_rms(rms, scale)
    plane = wavelet.forward_3d_volume(vol, vol.shape, block)
    fv, iv = quant.quantize(plane, glob_mulfac)
    fiv = iv.astype(jnp.float32)
    mask = (iv != 0).any(axis=1)
    # inverse map without scatters: rank among active rows, else sentinel
    ranks = jnp.cumsum(mask.astype(jnp.int32)) - 1
    acount = mask.sum(dtype=jnp.int32)
    return fiv, mask, ranks, acount, glob_mulfac


@functools.partial(jax.jit, static_argnames=("vol_shape", "block"))
def _snap_decode(payload, invmap, mulfac, vol_shape, block):
    from .ops import codec as _codec

    # dequantize the compressed-size payload rows, then ONE wide row
    # gather reproduces the volume-order coefficient plane.  The barrier
    # pins the dequantize rounding: without it XLA hoists the scalar
    # multiply across the inverse matmuls ((x*s)@W -> (x@W)*s), breaking
    # bit-parity with byte-stream decodes.
    deq = payload * quant.dequant_scalefac(mulfac)
    deq = jax.lax.optimization_barrier(deq)
    padded = jnp.concatenate(
        [deq, jnp.zeros((1, deq.shape[1]), jnp.float32)], axis=0
    )
    plane = jnp.take(padded, invmap, axis=0)
    return _codec._inverse_from_plane(plane, vol_shape, block)


def _plane_dims(vol_shape, block):
    nz, ny, nx = vol_shape
    bx, by, bz = block
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    nbx2 = wavelet.padded_nbx(nbx, bx)
    return nbz, nby, nbx, nbx2


class DeviceSnapshotStack:
    """Device-resident compressed snapshot sequence (see module docstring)."""

    def __init__(self, vol_shape, scale, block=(32, 32, 32), max_pending=2):
        bx, by, bz = block
        assert ctn.is_valid_block_size(bx, by, bz), "invalid block size"
        self.vol_shape = tuple(vol_shape)
        self.scale = float(scale)
        self.block = (bx, by, bz)
        self._snaps = []
        # speculative capacity: appends dispatch against the last-known
        # bucket without a blocking count readback (the count is fetched
        # asynchronously); validation is deferred at most `max_pending`
        # snapshots, bounding retained dense intermediates to O(max_pending)
        # volumes regardless of stack length.
        self._cap = None
        self._pending = []
        self._max_pending = max(1, int(max_pending))

    def append(self, vol):
        """Compress a device (or host) volume into the stack; returns index."""
        vol = jnp.asarray(vol, jnp.float32)
        assert vol.shape == self.vol_shape, (vol.shape, self.vol_shape)
        fiv, mask, ranks, acount, mulfac = _snap_encode(
            vol, jnp.float32(self.scale), self.block
        )
        try:  # start the d2h early so validation rarely blocks
            acount.copy_to_host_async()
        except Exception:
            pass
        if self._cap is None:
            self._cap = rle_device.bucket(int(acount), lo=1)  # sync once
        payload, invmap = _snap_sparsify(fiv, mask, ranks, self._cap)
        idx = len(self._snaps)
        self._snaps.append([payload, invmap, mulfac, None])
        self._pending.append((idx, acount, fiv, mask, ranks))
        while len(self._pending) > self._max_pending:
            self._validate_one()
        return idx

    def _validate_one(self):
        idx, acount_dev, fiv, mask, ranks = self._pending.pop(0)
        acount = int(acount_dev)
        if acount > self._snaps[idx][0].shape[0]:  # capacity overflow: redo
            self._cap = rle_device.bucket(acount, lo=1)
            payload, invmap = _snap_sparsify(fiv, mask, ranks, self._cap)
            self._snaps[idx][0] = payload
            self._snaps[idx][1] = invmap
        self._snaps[idx][3] = acount

    def flush(self):
        """Resolve all pending capacity validations (frees intermediates)."""
        while self._pending:
            self._validate_one()

    def get(self, i):
        """Reconstruct snapshot i as a device array (no host traffic)."""
        self.flush()
        payload, invmap, mulfac, _ = self._snaps[i]
        return _snap_decode(payload, invmap, mulfac, self.vol_shape, self.block)

    def __len__(self):
        return len(self._snaps)

    def pop(self):
        """Reconstruct and release the most recent snapshot (backward pass)."""
        vol = self.get(len(self._snaps) - 1)
        self._snaps.pop()
        return vol

    def nbytes(self):
        """Device memory held by the compressed snapshots."""
        self.flush()
        total = 0
        for payload, invmap, _, _ in self._snaps:
            total += payload.size * 4 + invmap.size * 4
        return total

    def ratio(self):
        """Aggregate compression ratio vs raw f32 snapshots."""
        raw = len(self._snaps) * int(np.prod(self.vol_shape)) * 4
        held = self.nbytes()
        return raw / held if held else float("inf")

    # ---------------------------------------------- container conversion

    def dense_fiv(self, i):
        """Snapshot i's scaled integers as a dense BLOCK-MAJOR (nnn, cells)
        float32 array (host) — the representation-agnostic view container
        conversion and parity tests use."""
        self.flush()
        payload, invmap, _, acount = self._snaps[i]
        inv = np.asarray(invmap)
        rows = np.asarray(payload[:acount]) if acount else \
            np.zeros((0, payload.shape[1]), F32)
        dense = np.zeros((inv.size, payload.shape[1]), dtype=F32)
        live = inv < payload.shape[0]
        if acount:
            dense[live] = rows[inv[live]]
        bx, by, bz = self.block
        cells = bx * by * bz
        nbz, nby, nbx, nbx2 = _plane_dims(self.vol_shape, self.block)
        p6 = dense.reshape(nbz, bz, nby, by, nbx2, bx)
        return np.ascontiguousarray(
            p6.transpose(0, 2, 4, 1, 3, 5)[:, :, :nbx]
        ).reshape(nbz * nby * nbx, cells)

    def to_container(self, i):
        """Snapshot i -> portable byte-stream container (through the host).

        Lossless: the stored values are the exact scaled integers, so the
        entropy stage re-encodes them verbatim (tokens chosen from the same
        integer values the direct codec path would emit); decoding the
        returned container with the jax backend reproduces `get(i)`
        bit-for-bit (other backends use the scalar inverse wavelet and
        match to the usual 1e-5-relative transform contract).  The header
        carries the stack's actual mulfac.
        """
        self.flush()
        nz, ny, nx = self.vol_shape
        mulfac = F32(np.asarray(self._snaps[i][2]))
        coeffs = self.dense_fiv(i)
        return _encode_fiv_container(
            coeffs, mulfac, (nx, ny, nz), self.block
        )

    def from_container(self, data):
        """Append a snapshot decoded from a byte-stream container.

        The container must be global-RMS with this stack's volume shape and
        block dims.  Exact for token-coded blocks: the scaled integers are
        recovered from the tokens directly (no dequantize/requantize round
        trip), so `get` on the new snapshot matches `decompress(data)`
        bit-for-bit.  Raw-fallback blocks (rare) store DEQUANTIZED
        coefficients that bypass the decoder's scalefac
        (CvxCompress.cpp:552-555); they are re-scaled by the header mulfac
        into the stack's fiv representation here, so their reconstruction
        matches `decompress(data)` to one f32 rounding (~1 ulp), not
        bit-for-bit.
        """
        from .ops import codec as _codec
        from .utils import io as _io

        _io.validate(data)
        hdr, blkoffs, blkmf, pbase = ctn.unpack(data)
        if hdr.use_local_rms:
            raise ValueError("snapshot stack is global-RMS only")
        if (hdr.nz, hdr.ny, hdr.nx) != self.vol_shape or (
            hdr.bx, hdr.by, hdr.bz
        ) != self.block:
            raise ValueError("container shape/block mismatch with stack")
        # decode with mulfac=1.0: token values come back as float(iv)
        # exactly (and VLESC4 floats verbatim) — the stack representation
        fiv = _codec._decode_payloads_host(
            data, ctn.Header(hdr.nx, hdr.ny, hdr.nz, hdr.bx, hdr.by, hdr.bz,
                             F32(1.0), False),
            blkoffs, None, pbase,
        )
        is_raw = np.asarray(blkoffs, dtype=np.int64) < 0
        if is_raw.any():
            # raw payloads came back verbatim (unscaled coefficients, not
            # fiv rows): restore the fiv representation the stack's
            # dequantizing get() expects
            fiv[is_raw] = (
                fiv[is_raw] * F32(hdr.glob_mulfac)
            ).astype(F32)
        bx, by, bz = self.block
        nbz, nby, nbx, nbx2 = _plane_dims(self.vol_shape, self.block)
        b6 = fiv.reshape(nbz, nby, nbx, bz, by, bx)
        if nbx2 > nbx:
            b6 = np.pad(b6, ((0, 0), (0, 0), (0, nbx2 - nbx),
                             (0, 0), (0, 0), (0, 0)))
        rows = np.ascontiguousarray(
            b6.transpose(0, 3, 1, 4, 2, 5)
        ).reshape(nbz * bz * nby * by, nbx2 * bx)
        live = rows.any(axis=1)
        acount = int(live.sum())
        acap = rle_device.bucket(acount, lo=1)
        pay = np.zeros((acap, rows.shape[1]), dtype=F32)
        pay[:acount] = rows[live]
        inv = np.full(rows.shape[0], acap, dtype=np.int32)
        inv[live] = np.arange(acount, dtype=np.int32)
        self._snaps.append([
            jnp.asarray(pay), jnp.asarray(inv),
            jnp.float32(hdr.glob_mulfac), acount,
        ])
        return len(self._snaps) - 1


def _encode_fiv_container(fiv_coeffs, mulfac, dims_xyz, block):
    """Entropy-encode scaled-integer coefficients into a container.

    Encoding runs with mulfac'=1.0 (trunc(1.0*fiv) == iv exactly) while the
    header records the true mulfac, so decoders reconstruct
    float(iv)*(1/mulfac) — the snapshot's own dequantization.  Raw-fallback
    blocks (encoded size > 4*cells) store the DEQUANTIZED values, since raw
    payloads bypass the decoder's scalefac multiply (CvxCompress.cpp:552).
    """
    from .oracle import rle as orle

    nx, ny, nz = dims_xyz
    nnn, cells = fiv_coeffs.shape
    try:
        from .ops import rle_host

        native = rle_host.available()
    except Exception:
        native = False

    scalefac = F32(1.0) / mulfac
    if native:
        from .ops import rle_host

        buf, stride, sizes, raw = rle_host.encode_payloads(
            fiv_coeffs, np.full(nnn, 1.0, dtype=F32)
        )
        payloads = []
        for b in range(nnn):
            if raw[b]:
                payloads.append(
                    (fiv_coeffs[b] * scalefac).astype(F32).tobytes()
                )
            else:
                payloads.append(buf[b, : sizes[b]].tobytes())
    else:
        payloads, raw = [], np.zeros(nnn, dtype=bool)
        for b in range(nnn):
            p = orle.encode(F32(1.0), fiv_coeffs[b])
            if len(p) > 4 * cells:
                raw[b] = True
                p = (fiv_coeffs[b] * scalefac).astype(F32).tobytes()
            payloads.append(p)

    hdr = ctn.Header(nx, ny, nz, block[0], block[1], block[2], mulfac, False)
    return ctn.pack(hdr, payloads, raw)
