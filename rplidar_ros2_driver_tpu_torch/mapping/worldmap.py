"""The shared-world mapping plane — cross-stream submap merge, bounded
membership, versioned tile serving.

The PyTorch counterpart of the JAX package's ``mapping/worldmap.py``.
Streams contribute FINALIZED submaps (the quantized planes + anchor poses
the loop-closure library materializes, through
``LoopClosureEngine.on_install``); the world map aligns each against a
fixed reference, fuses it into an int32 accumulation on its device, and
publishes quantized, run-length-compressed tile snapshots
(mapping/tiles.py) for readers.

Determinism contract, in three parts:

  * ALIGNMENT is computed exactly once per submap, on the host, with the
    matcher's bit-exact numpy twin (``match_scan_np``) against the frozen
    reference plane.  The stored member plane is the ALIGNED plane
    (integer cell translation, zero fill), so everything downstream is
    order-free.
  * FUSION is raw int32 addition on the device (``ops/tile_quant.
    fuse_accumulate``, in place): associative and commutative even at
    wrap, so any merge order is bit-identical (``fuse_planes_np`` is the
    shuffled-order oracle).  Clamping happens only at serving.
  * EVICTION is the exact inverse (``fuse_retract``): retracting a member
    restores the accumulation byte-for-byte to the sum of the survivors.
    Membership is capped at ``world_max_submaps``; member node indices
    are list positions.

The alignment result doubles as the inter-stream pose-graph constraint:
member j's row is (0, j, dpose, weight) against the reference node,
relaxed with the solver's numpy twin after every membership change.

Serving never touches the device on the read path: ``publish`` makes one
device->host copy of the accumulation, quantizes + tiles on the host and
swaps in an immutable versioned :class:`TileSnapshot`.  The accumulation
lives on the card unless the caller passes a CPU ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.mapping.tiles import (
    TileConfig,
    TileSnapshot,
    publish_tiles,
    resolve_map_tile_backend,
)
from rplidar_ros2_driver_tpu_torch.ops.loop_close import derive_match_config
from rplidar_ros2_driver_tpu_torch.ops.pose_graph import PoseGraphConfig
from rplidar_ros2_driver_tpu_torch.ops.pose_graph_ref import solve_pose_graph_np
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, MapConfig
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import match_scan_np
from rplidar_ros2_driver_tpu_torch.ops.tile_quant import (
    fuse_accumulate,
    fuse_retract,
)
from rplidar_ros2_driver_tpu_torch.utils import guards

WORLD_STATE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static world-map configuration.

    ``base`` is the fleet's MapConfig (submap planes arrive in its
    quantized form); ``match`` is the derived candidate-match config
    (quant_shift 0, clamp at the stored ceiling — the loop-closure
    derivation reused verbatim, same search radii)."""

    base: MapConfig
    match: MapConfig
    tile: TileConfig
    max_submaps: int = 16
    merge_revs: int = 4
    publish_ticks: int = 8

    def __post_init__(self):
        if self.max_submaps < 2:
            raise ValueError(
                "world_max_submaps must be >= 2 (the reference plus at "
                "least one mergeable member)"
            )
        if self.merge_revs < 1:
            raise ValueError("world_merge_revs must be >= 1")
        if self.publish_ticks < 1:
            raise ValueError("world_publish_ticks must be >= 1")
        if self.tile.grid != self.base.grid:
            raise ValueError(
                "tile plane and map grid must agree "
                f"({self.tile.grid} != {self.base.grid})"
            )

    @property
    def graph(self) -> PoseGraphConfig:
        """The inter-stream relaxation graph: one node per member
        (node 0 = the reference, the gauge anchor), one constraint row
        per non-reference member."""
        return PoseGraphConfig(
            max_nodes=self.max_submaps,
            max_constraints=max(self.max_submaps - 1, 1),
            theta_divisions=self.match.theta_divisions,
            t_limit_sub=self.match.t_limit_sub,
        )


def world_config_from_params(params, map_cfg: MapConfig) -> WorldConfig:
    """Build the WorldConfig from validated DriverParams + the fleet's
    MapConfig.  Cross-stream alignment shares the loop-closure search
    radii (``loop_theta_window`` / ``loop_window_cells``): re-visit
    drift and inter-stream offset are the same order of disagreement."""
    backend = resolve_map_tile_backend(params.map_tile_backend)
    return WorldConfig(
        base=map_cfg,
        match=derive_match_config(
            map_cfg,
            theta_window=int(params.loop_theta_window),
            window_cells=int(params.loop_window_cells),
        ),
        tile=TileConfig(
            grid=map_cfg.grid,
            tile_cells=int(params.world_tile_cells),
            clamp_q=map_cfg.clamp_q,
            backend=backend,
        ),
        max_submaps=int(params.world_max_submaps),
        merge_revs=int(params.world_merge_revs),
        publish_ticks=int(params.world_publish_ticks),
    )


@dataclasses.dataclass
class _Member:
    """One merged submap: its ALIGNED plane (the exact array fused
    into the accumulation — eviction subtracts this same array), the
    anchor it arrived with, and its constraint against the reference."""

    stream: int
    plane: np.ndarray          # (G, G) int32, aligned, as fused
    anchor: np.ndarray         # (3,) int32 arrival anchor pose
    z: np.ndarray              # (3,) int32 constraint (dpose vs ref)
    weight: int                # 0 = alignment failed; plane fused unshifted
    score: int


def shift_plane_np(plane, dx_cells: int, dy_cells: int) -> np.ndarray:
    """Translate a plane by whole cells with zero fill — the only
    transform fusion applies (rotation rides the pose-graph
    constraint, never the raster: a resampled rotation would break
    the exact-eviction group property)."""
    p = np.asarray(plane, np.int32)
    g = p.shape[0]
    out = np.zeros_like(p)
    sx0, sx1 = max(0, -dx_cells), min(g, g - dx_cells)
    sy0, sy1 = max(0, -dy_cells), min(g, g - dy_cells)
    if sx0 < sx1 and sy0 < sy1:
        out[sx0 + dx_cells : sx1 + dx_cells, sy0 + dy_cells : sy1 + dy_cells] = (
            p[sx0:sx1, sy0:sy1]
        )
    return out


class WorldMap:
    """The fleet's shared world: device accumulation + host membership
    + published tile snapshots.  Single-writer (the service's drain
    loop), many readers (any holder of a published snapshot).  The
    accumulation lives on ``device``: the card unless the caller passes a
    CPU device (no card raises)."""

    def __init__(self, cfg: WorldConfig, *, device=None):
        from rplidar_ros2_driver_tpu_torch.filters.chain import pick_device

        self.cfg = cfg
        self.device = torch.device(device) if device is not None else pick_device("cuda")
        g = cfg.tile.grid
        self._acc = torch.zeros((g, g), dtype=torch.int32, device=self.device)
        self._members: list[_Member] = []
        self._nodes = np.zeros((cfg.graph.max_nodes, 3), np.int32)
        self._last_rev: dict[int, int] = {}
        self._snapshot: Optional[TileSnapshot] = None
        self._ticks = 0
        self._dirty = False
        self.merges = 0
        self.evictions = 0
        self.serving_version = 0

    # -- warm-up ----------------------------------------------------------

    def precompile(self) -> None:
        """Run both fusion ops once at the world-plane shape (the first
        call's allocations out of the way).  Adding/subtracting zeros
        leaves the accumulation byte-identical."""
        zero = torch.zeros_like(self._acc)
        fuse_accumulate(self._acc, zero)
        fuse_retract(self._acc, zero)

    def _upload(self, plane: np.ndarray) -> torch.Tensor:
        # always a copy: the accumulation is updated in place, and a CPU
        # tensor from_numpy would share the caller's (maybe read-only)
        # buffer; the upload is a declared transfer (utils/guards)
        with guards.declared_sync():
            return torch.tensor(np.asarray(plane, np.int32), device=self.device)

    def accumulation(self) -> np.ndarray:
        """A host copy of the accumulation (one declared device->host
        copy: the serving pod publishes inside its guarded drain loop)."""
        with guards.declared_sync():
            return self._acc.cpu().numpy().copy()

    # -- merge cadence ----------------------------------------------------

    def merge_due(self, stream: int, revision: int) -> bool:
        """Is a cross-stream merge due for this stream at this
        revolution count?  Same modular cadence as submap
        finalization, deduplicated per stream (a super-tick can hold
        several ticks at one revision)."""
        rev = int(revision)
        return (
            rev > 0
            and rev % self.cfg.merge_revs == 0
            and self._last_rev.get(int(stream)) != rev
        )

    def note_merged(self, stream: int, revision: int) -> None:
        self._last_rev[int(stream)] = int(revision)

    # -- alignment (host, bit-exact twin — one code path) -----------------

    def _pseudo_scan(self, plane: np.ndarray):
        """Turn a quantized submap plane into the matcher's point-set
        form: one subcell point at the bilinear ANCHOR of every
        occupied cell (subcell offset 0 — full weight lands on exactly
        that cell, so a whole-cell translation scores a sharp maximum
        instead of a 4-way split).  Row-major order; even-stride
        decimation past the beam cap — deterministic, and it keeps
        full-plane coverage instead of truncating to the top rows."""
        cfg = self.cfg.match
        g = cfg.grid
        occ = np.argwhere(np.asarray(plane, np.int32) > 0)
        n = occ.shape[0]
        if n > cfg.beams:
            sel = (np.arange(cfg.beams, dtype=np.int64) * n) // cfg.beams
            occ = occ[sel]
            n = cfg.beams
        center = (g // 2) * SUB
        pq = np.zeros((cfg.beams, 2), np.int32)
        ok = np.zeros((cfg.beams,), np.int32)
        if n:
            pq[:n] = occ.astype(np.int32) * SUB - center
            ok[:n] = 1
        return pq, ok, n

    def align_submap(self, plane):
        """Align one quantized submap plane against the frozen
        reference: ``(dpose, score)`` with dpose translation in
        subcells (exact multiples of SUB — the matcher searches whole
        cells at the fine stage, so ``dpose // SUB`` is the exact cell
        shift)."""
        if not self._members:
            raise RuntimeError("align_submap needs a reference member")
        pq, ok, n = self._pseudo_scan(np.asarray(plane, np.int32))
        if n == 0:
            return np.zeros((3,), np.int32), 0
        dpose, score, _ = match_scan_np(
            self._members[0].plane,
            np.zeros((3,), np.int32),
            pq,
            ok,
            self.cfg.match,
        )
        return np.asarray(dpose, np.int32), int(score)

    # -- merge / evict ----------------------------------------------------

    def ingest_submap(self, stream: int, plane, anchor) -> int:
        """Merge one finalized submap into the world: align against
        the reference, fuse the ALIGNED plane into the device
        accumulation, append the membership row, relax the
        inter-stream graph.  Returns the member's node index.  Evicts
        the oldest non-reference member first when at capacity, so the
        resident set stays bounded."""
        plane = np.asarray(plane, np.int32).copy()
        anchor = np.asarray(anchor, np.int32).copy()
        if len(self._members) >= self.cfg.max_submaps:
            self.evict_oldest()
        if not self._members:
            # first arrival freezes the world frame: the reference
            # plane is the alignment target for every later member
            member = _Member(
                stream=int(stream), plane=plane, anchor=anchor,
                z=np.zeros((3,), np.int32), weight=0, score=0,
            )
        else:
            dpose, score = self.align_submap(plane)
            weight = 1 if score > 0 else 0
            if weight:
                aligned = shift_plane_np(
                    plane, int(dpose[0]) // SUB, int(dpose[1]) // SUB
                )
            else:
                # no overlap evidence: fuse unshifted at zero weight —
                # the graph ignores it, and eviction still subtracts
                # the exact array that was added
                aligned = plane
            member = _Member(
                stream=int(stream), plane=aligned, anchor=anchor,
                z=np.asarray(dpose, np.int32), weight=weight,
                score=int(score),
            )
        fuse_accumulate(self._acc, self._upload(member.plane))
        self._members.append(member)
        self.merges += 1
        self._dirty = True
        self._relax()
        return len(self._members) - 1

    def evict_oldest(self) -> int:
        """Evict the oldest NON-reference member (the reference is the
        alignment frame and never leaves): subtract its exact fused
        plane back out of the accumulation and pop its row — node
        indices ARE list positions, so the pop is the index remap and
        every surviving constraint follows its member."""
        if len(self._members) < 2:
            raise RuntimeError("no evictable member (reference only)")
        member = self._members.pop(1)
        fuse_retract(self._acc, self._upload(member.plane))
        self.evictions += 1
        self._dirty = True
        self._relax()
        return member.stream

    def _relax(self) -> None:
        """Relax the inter-stream graph with the pose-graph solver's
        bit-exact numpy twin: node j = member j (node 0 the gauge
        anchor), one constraint row per non-reference member."""
        gcfg = self.cfg.graph
        nodes0 = np.zeros((gcfg.max_nodes, 3), np.int32)
        cons = np.zeros((gcfg.max_constraints, 6), np.int32)
        for j, m in enumerate(self._members):
            if j == 0:
                continue
            nodes0[j] = m.z
            cons[j - 1] = (0, j, m.z[0], m.z[1], m.z[2], m.weight)
        self._nodes = solve_pose_graph_np(nodes0, cons, gcfg)

    def world_nodes(self) -> np.ndarray:
        """Relaxed member poses (world frame), one row per member."""
        return self._nodes[: len(self._members)].copy()

    # -- serving ----------------------------------------------------------

    def tick(self) -> bool:
        """Advance the serving clock one drain tick; True when a
        publication is due (dirty accumulation at the cadence edge, or
        a first snapshot that has never been published)."""
        self._ticks += 1
        due = self._dirty and (
            self._snapshot is None
            or self._ticks % self.cfg.publish_ticks == 0
        )
        return due

    def publish(self) -> TileSnapshot:
        """Publish the next versioned tile snapshot: one EXPLICIT
        device fetch of the accumulation, then pure host quantize +
        tile + RLE.  No dispatch — this is the work that rides the
        idle double-buffer half via the ``overlap_work`` hook."""
        plane = self.accumulation()
        snap = publish_tiles(
            plane, self.cfg.tile, self.serving_version + 1
        )
        self.serving_version = snap.version
        self._snapshot = snap
        self._dirty = False
        return snap

    # graftlint: read-path
    def snapshot(self) -> Optional[TileSnapshot]:
        """The latest published serving view — immutable; readers keep
        whatever version they grabbed.  None until first publication."""
        return self._snapshot

    def overlap_hook(self) -> Optional[Callable[[], None]]:
        """A zero-arg publication callback when one is due, else None
        — the exact shape ``submit_bytes_backlog(overlap_work=...)``
        expects, so the service can chain it onto the idle-half work."""
        if not self.tick():
            return None

        def _publish():
            self.publish()

        return _publish

    # -- accounting -------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        """Bytes the world holds resident: the device accumulation,
        every member's aligned plane (the eviction ledger), and the
        published payload.  Bounded by construction — membership is
        capped and a snapshot replaces its predecessor."""
        g = self.cfg.tile.grid
        acc = g * g * 4
        planes = sum(int(m.plane.nbytes) for m in self._members)
        snap = self._snapshot.payload_bytes if self._snapshot else 0
        return acc + planes + snap

    # graftlint: read-path
    def status(self) -> dict:
        """The /diagnostics "World Map" payload."""
        snap = self._snapshot
        return {
            "backend": self.cfg.tile.backend,
            "nodes": len(self._members),
            "tiles": snap.tiles if snap else 0,
            "resident_bytes": int(self.resident_bytes),
            "compression_ratio": (
                round(snap.compression_ratio, 2) if snap else 0.0
            ),
            "merges": int(self.merges),
            "serving_version": int(self.serving_version),
            "evictions": int(self.evictions),
        }

    # -- state carry ------------------------------------------------------

    def save_state(self) -> dict:
        """Snapshot the whole world for checkpoint/restore (host
        arrays only; the accumulation fetches explicitly)."""
        return {
            "version": WORLD_STATE_VERSION,
            "acc": self.accumulation(),
            "members": [
                {
                    "stream": m.stream,
                    "plane": m.plane.copy(),
                    "anchor": m.anchor.copy(),
                    "z": m.z.copy(),
                    "weight": m.weight,
                    "score": m.score,
                }
                for m in self._members
            ],
            "last_rev": dict(self._last_rev),
            "ticks": self._ticks,
            "dirty": self._dirty,
            "merges": self.merges,
            "evictions": self.evictions,
            "serving_version": self.serving_version,
        }

    def load_state(self, state: dict) -> None:
        """Restore a saved world byte-for-byte (schema-checked; the
        snapshot republishes lazily at the next cadence edge)."""
        if state.get("version") != WORLD_STATE_VERSION:
            raise ValueError(
                "world map state version mismatch: saved "
                f"{state.get('version')!r}, code {WORLD_STATE_VERSION}"
            )
        acc = np.asarray(state["acc"], np.int32)
        if acc.shape != (self.cfg.tile.grid, self.cfg.tile.grid):
            raise ValueError(
                "world map restore geometry mismatch: saved "
                f"{acc.shape}, config grid {self.cfg.tile.grid}"
            )
        self._acc = self._upload(acc)
        self._members = [
            _Member(
                stream=int(m["stream"]),
                plane=np.asarray(m["plane"], np.int32),
                anchor=np.asarray(m["anchor"], np.int32),
                z=np.asarray(m["z"], np.int32),
                weight=int(m["weight"]),
                score=int(m["score"]),
            )
            for m in state["members"]
        ]
        self._last_rev = {
            int(k): int(v) for k, v in state["last_rev"].items()
        }
        self._ticks = int(state["ticks"])
        self._dirty = bool(state["dirty"])
        self.merges = int(state["merges"])
        self.evictions = int(state["evictions"])
        self.serving_version = int(state["serving_version"])
        self._snapshot = None
        self._relax()
