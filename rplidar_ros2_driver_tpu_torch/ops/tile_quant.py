"""Integer tile quantization + run-length ops — the world map's wire form.

A copy of the JAX package's ``ops/tile_quant.py`` (its numpy coding,
verbatim) with the two device ops in PyTorch.  The shared-world plane
(mapping/worldmap.py) accumulates per-stream submap log-odds as RAW int32
sums: integer addition is associative and commutative even at wrap, so ANY
merge order — per-stream, shuffled, or sharded partial sums merged later —
lands the bit-identical accumulation.  This module holds the two halves of
that plane's arithmetic contract:

  * FUSION — ``fuse_accumulate`` / ``fuse_retract``: the device-resident
    merge and its exact inverse, in place on the accumulation tensor
    (int32 addition forms a group, so evicting a submap is a subtraction
    that restores the accumulation byte-for-byte to the sum of the
    survivors).  Two's-complement wrap is the group contract.
  * SERVING QUANTIZATION — SR-LIO++-style int8/int4 level coding of the
    clamped accumulation plus nibble packing and run-length encoding, all
    pure integer numpy (its own reference).  The round-trip error is
    BOUNDED by construction: a level reconstructs at its band midpoint, so
    occupied cells (level > 0) land within ``2^(shift-1)`` of the clamped
    value and empty-band cells (level 0) within ``2^shift - 1`` — and
    level 0 reconstructs to exactly 0, so unknown space stays unknown.

Quantization only ever runs at PUBLISH time, on the host, from an
explicitly fetched copy of the accumulation — the int32 sum is the system
of record and fusion never sees a quantization error.
"""

from __future__ import annotations

import numpy as np
import torch

TILE_QUANT_VERSION = 1

# serialized run cost: one int32 level is coded as a value byte (int8)
# or value nibble (int4) plus a 16-bit run length — the accounting the
# compression-ratio headline uses (bench --config 22)
RUN_LEN_BYTES = 2
RUN_LEN_MAX = (1 << (8 * RUN_LEN_BYTES)) - 1


def min_tile_shift(clamp_q: int, bits: int) -> int:
    """Smallest right shift putting ``[0, clamp_q]`` into ``bits``
    unsigned levels — the tile analog of scan_match.min_quant_shift
    (same derivation: the level count is the hard ceiling, the shift
    is whatever clears it)."""
    if clamp_q < 1:
        raise ValueError("clamp_q must be positive")
    if bits < 1:
        raise ValueError("bits must be >= 1")
    levels = (1 << bits) - 1
    shift = 0
    while (clamp_q >> shift) > levels:
        shift += 1
    return shift


def quant_error_bound(shift: int) -> int:
    """Worst-case |dequantize(quantize(v)) - clip(v)| for OCCUPIED
    cells (level > 0): the band-midpoint distance ``2^(shift-1)``.
    Level-0 cells reconstruct to exactly 0, so their bound is the band
    width minus one, ``2^shift - 1`` (both pinned by test)."""
    return (1 << shift) >> 1


def quantize_plane(plane, clamp_q: int, shift: int) -> np.ndarray:
    """Clamp an int32 log-odds plane to ``[0, clamp_q]`` and code each
    cell as its ``>> shift`` level (int32 holding small unsigned
    values; the wire layer narrows).  Pure integer — its own
    reference, like quantize_submap_plane."""
    lo = np.clip(np.asarray(plane, np.int32), 0, int(clamp_q))
    return (lo >> int(shift)).astype(np.int32)


def dequantize_plane(levels, shift: int) -> np.ndarray:
    """Reconstruct each level at its band midpoint; level 0 stays
    exactly 0 (unknown space must not acquire phantom occupancy)."""
    lv = np.asarray(levels, np.int32)
    half = (1 << int(shift)) >> 1
    return np.where(lv > 0, (lv << int(shift)) + half, 0).astype(np.int32)


def pack_nibbles(levels) -> np.ndarray:
    """Pack int4 levels (values in [0, 15]) two per byte, low nibble
    first; odd counts pad with a zero nibble."""
    lv = np.asarray(levels, np.int32).reshape(-1)
    if lv.size % 2:
        lv = np.concatenate([lv, np.zeros((1,), np.int32)])
    return ((lv[0::2] & 0xF) | ((lv[1::2] & 0xF) << 4)).astype(np.uint8)


def unpack_nibbles(packed, count: int) -> np.ndarray:
    """Inverse of :func:`pack_nibbles` — ``count`` trims the pad."""
    p = np.asarray(packed, np.uint8).astype(np.int32)
    lv = np.empty((p.size * 2,), np.int32)
    lv[0::2] = p & 0xF
    lv[1::2] = (p >> 4) & 0xF
    return lv[: int(count)]


def rle_encode(levels) -> tuple:
    """Run-length code a flat level array: ``(values, runs)`` int32,
    runs capped at ``RUN_LEN_MAX`` (a longer run splits — the 16-bit
    run field is the wire contract).  Deterministic and pure integer."""
    lv = np.asarray(levels, np.int32).reshape(-1)
    if lv.size == 0:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    edges = np.flatnonzero(np.diff(lv)) + 1
    starts = np.concatenate([np.zeros((1,), np.int64), edges])
    ends = np.concatenate([edges, np.asarray([lv.size], np.int64)])
    values, runs = [], []
    for s, e in zip(starts, ends):
        n = int(e - s)
        v = int(lv[s])
        while n > RUN_LEN_MAX:
            values.append(v)
            runs.append(RUN_LEN_MAX)
            n -= RUN_LEN_MAX
        values.append(v)
        runs.append(n)
    return (
        np.asarray(values, np.int32),
        np.asarray(runs, np.int32),
    )


def rle_decode(values, runs) -> np.ndarray:
    """Inverse of :func:`rle_encode`."""
    return np.repeat(
        np.asarray(values, np.int32), np.asarray(runs, np.int64)
    ).astype(np.int32)


def rle_payload_bytes(n_runs: int, bits: int) -> int:
    """Serialized size of an RLE stream: one level (byte or packed
    nibble) plus a ``RUN_LEN_BYTES`` run count per run."""
    n = int(n_runs)
    if bits == 4:
        value_bytes = (n + 1) // 2
    else:
        value_bytes = n
    return value_bytes + RUN_LEN_BYTES * n


# ---------------------------------------------------------------------------
# device-resident fusion — the merge op and its exact inverse
# ---------------------------------------------------------------------------


def fuse_accumulate(acc: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """``acc += plane`` in place (int32, wrap included) and return ``acc``
    — the world merge op.  int32 addition is associative/commutative, so
    any merge order is bit-identical; :func:`fuse_planes_np` is the same
    expression on the host."""
    return acc.add_(plane)


def fuse_retract(acc: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """``acc -= plane`` in place and return ``acc`` — submap EVICTION.
    Addition forms a group over int32, so retracting a member restores the
    accumulation byte-for-byte to the sum of the survivors."""
    return acc.sub_(plane)


# graftlint: disable=GL011 — host twin of the wrap-group accumulation
def fuse_planes_np(planes) -> np.ndarray:
    """Host twin of an arbitrary-order fusion: the plain int32 sum of
    a sequence of planes (the shuffled-order oracle the bench and
    tests fold against the device accumulation)."""
    out = None
    for p in planes:
        arr = np.asarray(p, np.int32)
        out = arr.copy() if out is None else out + arr
    if out is None:
        raise ValueError("fuse_planes_np needs at least one plane")
    return out
