"""Quantized, run-length-compressed map tiles — the serving form of
the shared-world plane (``map_tile_backend`` seam).

The world accumulation (mapping/worldmap.py) is a raw int32 (G, G)
sum; nobody should have to pull 4 bytes per cell across the link to
READ it.  A :class:`TileSnapshot` is the published view: the plane
splits into ``tile_cells``-square tiles, all-empty tiles are dropped
outright (a mapped room is sparse in a large grid), and each resident
tile's levels run-length code under the resolved backend:

  * ``raw``  — dense int32 tiles, no quantization (the A/B baseline
    arm and the lossless escape hatch);
  * ``int8`` — 8-bit levels (255 bands over ``[0, clamp_q]``) + RLE;
  * ``int4`` — 4-bit levels, nibble-packed, + RLE — the SR-LIO++
    operating point (PAPERS.md): coarse occupancy bands are enough
    for serving, and the wire cost collapses;
  * ``auto`` — int8.  Quantized serving is a CAPACITY feature (the
    whole point of the tile plane is resident/wire state scaling past
    per-stream grids) with a validated error bound, so auto does not
    wait for on-chip evidence the way the perf seams do; the
    ``map_serving_ab`` decision key (scripts/decide_backends.py)
    governs only the on-chip serving-latency claim.

A snapshot is immutable once published and carries its serving
``version``: readers hold a consistent view by construction — the
writer never mutates a published snapshot, it publishes the next one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.tile_quant import (
    TILE_QUANT_VERSION,
    dequantize_plane,
    min_tile_shift,
    pack_nibbles,
    quant_error_bound,
    quantize_plane,
    rle_decode,
    rle_encode,
    rle_payload_bytes,
    unpack_nibbles,
)

_TILE_BACKENDS = ("raw", "int8", "int4")


def resolve_map_tile_backend(
    requested: str, platform: Optional[str] = None
) -> str:
    """Resolve the ``auto`` tile backend (explicit requests pass
    through).  ``auto`` -> ``int8`` on every platform: the quantized
    tile plane is a capacity feature with a validated error bound,
    not a perf flip waiting on on-chip evidence — the decision key
    only governs the serving-latency claim."""
    if requested != "auto":
        if requested not in _TILE_BACKENDS:
            raise ValueError(
                f"map_tile_backend must resolve to one of "
                f"{_TILE_BACKENDS}, got {requested!r}"
            )
        return requested
    del platform
    return "int8"


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static tile-plane geometry + the resolved serving backend."""

    grid: int
    tile_cells: int
    clamp_q: int
    backend: str = "int8"

    def __post_init__(self):
        if self.grid < 1:
            raise ValueError("tile plane needs a positive grid")
        if self.tile_cells < 1:
            raise ValueError("world_tile_cells must be >= 1")
        if self.grid % self.tile_cells != 0:
            raise ValueError(
                f"world_tile_cells ({self.tile_cells}) must divide the "
                f"map grid ({self.grid}) — partial edge tiles would "
                "give the same cell two serving addresses"
            )
        if self.clamp_q < 1:
            raise ValueError("clamp_q must be positive")
        if self.backend not in _TILE_BACKENDS:
            raise ValueError(
                f"tile backend must be one of {_TILE_BACKENDS}, got "
                f"{self.backend!r}"
            )

    @property
    def bits(self) -> int:
        return {"raw": 32, "int8": 8, "int4": 4}[self.backend]

    @property
    def quant_shift(self) -> int:
        if self.backend == "raw":
            return 0
        return min_tile_shift(self.clamp_q, self.bits)

    @property
    def error_bound(self) -> int:
        """Round-trip bound for OCCUPIED cells (level > 0); raw is
        lossless."""
        if self.backend == "raw":
            return 0
        return quant_error_bound(self.quant_shift)

    @property
    def tiles_per_side(self) -> int:
        return self.grid // self.tile_cells


@dataclasses.dataclass
class TileSnapshot:
    """One published, immutable serving view of the world plane.

    ``tile_ids`` are row-major indices of the RESIDENT (non-empty)
    tiles; the payload arrays concatenate every resident tile's RLE
    stream in id order (``tile_nruns`` splits them).  ``raw`` backend
    snapshots carry dense int32 tiles instead.  ``payload_bytes`` is
    the serialized wire size under the backend's coding;
    ``raw_bytes`` is the full dense int32 grid it replaces — their
    ratio is the compression headline."""

    version: int
    cfg: TileConfig
    tile_ids: np.ndarray          # (T,) int32
    values: np.ndarray            # (R,) int32 RLE levels (empty for raw)
    runs: np.ndarray              # (R,) int32 RLE run lengths
    tile_nruns: np.ndarray        # (T,) int32 runs per tile
    dense: Optional[np.ndarray]   # (T, tc, tc) int32 (raw backend only)
    payload_bytes: int
    raw_bytes: int
    schema: int = TILE_QUANT_VERSION

    @property
    def tiles(self) -> int:
        return int(self.tile_ids.size)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.payload_bytes, 1)


def publish_tiles(plane, cfg: TileConfig, version: int) -> TileSnapshot:
    """Quantize + tile + RLE one host copy of the world accumulation
    into an immutable :class:`TileSnapshot`.  Pure host integer work —
    no dispatch, which is what lets the publication ride the idle half
    of the staging double buffer (the ``overlap_work`` hook)."""
    g, tc = cfg.grid, cfg.tile_cells
    n = cfg.tiles_per_side
    arr = np.asarray(plane, np.int32).reshape(g, g)
    if cfg.backend == "raw":
        lv = np.clip(arr, 0, cfg.clamp_q)
    else:
        lv = quantize_plane(arr, cfg.clamp_q, cfg.quant_shift)
    # (n, n, tc, tc) row-major tile view; a tile is resident when any
    # cell holds a non-zero level
    tiles = lv.reshape(n, tc, n, tc).transpose(0, 2, 1, 3)
    resident = np.flatnonzero(
        tiles.reshape(n * n, -1).any(axis=1)
    ).astype(np.int32)
    if cfg.backend == "raw":
        dense = tiles.reshape(n * n, tc, tc)[resident].astype(np.int32)
        payload = int(dense.size) * 4
        return TileSnapshot(
            version=int(version), cfg=cfg, tile_ids=resident,
            values=np.zeros((0,), np.int32),
            runs=np.zeros((0,), np.int32),
            tile_nruns=np.zeros((resident.size,), np.int32),
            dense=dense, payload_bytes=payload, raw_bytes=g * g * 4,
        )
    values, runs, nruns = [], [], []
    flat = tiles.reshape(n * n, tc * tc)
    for tid in resident:
        v, r = rle_encode(flat[tid])
        values.append(v)
        runs.append(r)
        nruns.append(v.size)
    cat = (
        np.concatenate(values) if values else np.zeros((0,), np.int32)
    )
    if cfg.backend == "int4":
        # the wire form packs level nibbles; the snapshot keeps int32
        # levels for direct reads and prices the payload at the packed
        # size (pack/unpack round-trips are pinned by test)
        assert unpack_nibbles(pack_nibbles(cat), cat.size).shape == cat.shape
    payload = rle_payload_bytes(int(cat.size), cfg.bits)
    return TileSnapshot(
        version=int(version), cfg=cfg, tile_ids=resident,
        values=cat,
        runs=(
            np.concatenate(runs) if runs else np.zeros((0,), np.int32)
        ),
        tile_nruns=np.asarray(nruns, np.int32),
        dense=None, payload_bytes=payload, raw_bytes=g * g * 4,
    )


# graftlint: read-path
def snapshot_grid(snap: TileSnapshot) -> np.ndarray:
    """Reconstruct the full (G, G) int32 serving grid from a
    snapshot: dropped tiles are zero, resident tiles dequantize at
    band midpoints (raw tiles are exact).  This is the READER's path —
    pure host work over an immutable snapshot, never a device touch."""
    cfg = snap.cfg
    g, tc, n = cfg.grid, cfg.tile_cells, cfg.tiles_per_side
    tiles = np.zeros((n * n, tc, tc), np.int32)
    if cfg.backend == "raw":
        if snap.tile_ids.size:
            tiles[snap.tile_ids] = snap.dense
    else:
        off = 0
        for k, tid in enumerate(snap.tile_ids):
            nr = int(snap.tile_nruns[k])
            lv = rle_decode(
                snap.values[off:off + nr], snap.runs[off:off + nr]
            )
            tiles[tid] = dequantize_plane(lv, cfg.quant_shift).reshape(
                tc, tc
            )
            off += nr
    return (
        tiles.reshape(n, n, tc, tc).transpose(0, 2, 1, 3).reshape(g, g)
    )
