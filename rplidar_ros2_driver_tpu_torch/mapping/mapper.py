"""FleetMapper — the SLAM front-end driver (``map_backend`` seam).

The PyTorch counterpart of the JAX package's ``mapping/mapper.py``.  It
takes the filter chain's outputs (or stream-stacked Cartesian endpoints)
and keeps one :class:`MapState` row per stream: each revolution is matched
against that stream's log-odds map, the accepted pose delta composed in,
and the map updated from the scan (ops/scan_match.py).

Backends:

  * ``host``  — the NumPy golden reference (ops/scan_match_ref.py), one
    step per stream on the host.
  * ``fused`` — the device path: N streams in one fleet tick
    (ops/scan_match.fleet_map_match_step), state updated in place on the
    mapper's device.  With ``match_backend="pallas"`` each tick launches
    each matcher kernel (B6, B7, B8) once for all streams.
  * ``auto``  — ``fused`` on a CUDA device, ``host`` on the CPU.

Where this differs from the JAX package: its resolvers keep ``auto`` on
``host`` and ``xla`` until an on-chip A/B clears its decision bar; here
``auto`` follows the device, like the chain's ``resolve_median_backend``:
the port's entry points run on the card (with its kernels) unless the
caller asks for the CPU.  Both arms are bit-exact against each other and
against the JAX package, so the choice changes speed only.

Checkpoint surface: ``snapshot``/``restore`` (and per stream) in the JAX
package's format (numpy arrays, ``version`` key 1), so a map carries
across the two packages byte for byte; ``save_sharded``/``load_sharded``
(fused backend) write and read the stacked MapState with
torch.distributed.checkpoint (utils/checkpoint_sharded.py).

:class:`CarriedFleetMapper` is the mapper face of the fused mapping route
(``fused_mapping_backend='fused'``): the map rides the fused ingest state
and is updated inside its tick, so that face dispatches nothing and reads
and writes the engine's carried planes.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.utils import guards
from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    LO_SCALE,
    MAP_STATE_VERSION,
    STATE_DTYPES,
    STATE_KEYS,
    MapConfig,
    MapState,
    fleet_map_match_step,
    min_quant_shift,
    pose_to_metric,
)

log = logging.getLogger("rplidar_tpu.mapper")


def resolve_map_backend(requested: str, platform: Optional[str] = None) -> str:
    """``auto`` -> ``fused`` on a CUDA device, ``host`` otherwise;
    explicit requests pass through.  ``platform`` is the torch device
    type of the mapper's device."""
    if requested != "auto":
        return requested
    return "fused" if platform == "cuda" else "host"


def resolve_match_backend(requested: str, platform: Optional[str] = None) -> str:
    """``auto`` -> ``pallas`` (the CUDA kernels B6/B7/B8) on a CUDA device,
    ``xla`` (plain PyTorch) otherwise; explicit requests pass through."""
    if requested != "auto":
        return requested
    return "pallas" if platform == "cuda" else "xla"


def resolve_fused_mapping_backend(requested: str, platform: Optional[str] = None) -> str:
    """``auto`` -> ``host`` (the JAX package's choice): the map rides its
    own fleet tick after the ingest step.  ``fused`` carries the map in
    the fused ingest state and updates it inside the tick."""
    if requested != "auto":
        return requested
    del platform
    return "host"


def fused_mapping_map_config(params, beams: int, platform: Optional[str] = None
                             ) -> Optional[MapConfig]:
    """The carried mapper's MapConfig, or None when the fused mapping
    route is off — the one place where the route's resolution meets the
    params -> MapConfig mapping, so the engine and the service agree."""
    backend = resolve_fused_mapping_backend(
        getattr(params, "fused_mapping_backend", "auto"), platform)
    if backend != "fused" or not getattr(params, "map_enable", False):
        return None
    return map_config_from_params(params, beams, platform=platform)


def map_config_from_params(params, beams: int = 2048, platform: Optional[str] = None) -> MapConfig:
    """The one params -> MapConfig mapping (the JAX package's): the Q10
    quantization of the float log-odds parameters happens here only.
    ``platform`` (a torch device type) resolves the ``auto`` backends."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import resolve_voxel_backend

    cell = float(params.map_cell_m)
    coarse = 4
    clamp_q = int(round(params.map_log_odds_clamp * LO_SCALE))
    return MapConfig(
        grid=int(params.map_grid),
        cell_m=cell,
        beams=beams,
        hit_q=int(round(params.map_log_odds_hit * LO_SCALE)),
        miss_q=int(round(params.map_log_odds_miss * LO_SCALE)),
        clamp_q=clamp_q,
        decay_q=int(round(getattr(params, "map_decay", 0.0) * LO_SCALE)),
        coarse=coarse,
        window_cells=max(1, int(math.ceil(params.map_match_window / (cell * coarse)))),
        fine_radius=coarse,
        quant_shift=min_quant_shift(clamp_q, beams),
        voxel_backend=resolve_voxel_backend(getattr(params, "voxel_backend", "auto"), platform),
        match_backend=resolve_match_backend(getattr(params, "match_backend", "auto"), platform),
    )


def recon_input_planes(recons, streams: int, beams: int):
    """Mapper input planes (points / masks / live) from a list of
    ``(plane, pts)`` reconstructed sweeps, None for an idle stream —
    ``pts[:, :2]`` are the endpoints, ``pts[:, 2] > 0.5`` the mask."""
    points = np.zeros((streams, beams, 2), np.float32)
    masks = np.zeros((streams, beams), bool)
    live = np.zeros((streams,), np.int32)
    for i, rec in enumerate(recons):
        if rec is None:
            continue
        _plane, pts = rec
        points[i] = pts[:, :2]
        masks[i] = pts[:, 2] > 0.5
        live[i] = 1
    return points, masks, live


def clamp_pose_q(pose_q, cfg: MapConfig) -> np.ndarray:
    """Host-side pose normalization: translation clipped into the map,
    heading wrapped onto the rotation table."""
    pose = np.asarray(pose_q, np.int32).reshape(3)
    lim = cfg.t_limit_sub
    return np.asarray([
        np.clip(pose[0], -lim, lim),
        np.clip(pose[1], -lim, lim),
        np.mod(pose[2], cfg.theta_divisions),
    ], np.int32)


def is_carried(mapper) -> bool:
    """Is this mapper face the carried one (its map rows live inside the
    ingest state)?  Every checkpoint site that must not pull the same map
    rows a second time asks here."""
    return getattr(mapper, "backend", None) == "carried"


def carried_map_row(ingest_snap: dict) -> dict:
    """One per-stream ingest snapshot's carried map planes
    (``ingest.map_*``, snapshot v3) in FleetMapper's stream-row format."""
    row = {k: np.asarray(ingest_snap[f"ingest.map_{k}"]) for k in STATE_KEYS}
    row["version"] = np.asarray(MAP_STATE_VERSION, np.int32)
    return row


@dataclasses.dataclass(frozen=True)
class PoseEstimate:
    """One stream's per-revolution match result (host numpy/floats)."""

    x_m: float
    y_m: float
    theta_rad: float
    score: int            # raw integer correlation score (0 = rejected)
    matched_points: int   # valid endpoints that entered the match
    revision: int         # map revisions absorbed so far
    pose_q: np.ndarray    # (3,) int32 raw fixed-point pose


class FleetMapper:
    """Per-stream log-odds mapper + correlative matcher driver.

    Every state access serializes on one lock (the fused tick updates the
    state in place).  ``ticks`` and ``dispatch_count`` count fleet ticks
    and fused device steps, so a run can show one step per fleet tick."""

    def __init__(self, params, streams: int = 1, *, beams: Optional[int] = None,
                 device=None) -> None:
        from rplidar_ros2_driver_tpu_torch.filters.chain import DEFAULT_BEAMS, pick_device

        if streams < 1:
            raise ValueError("mapper needs at least one stream")
        self.streams = streams
        requested = getattr(params, "map_backend", "auto")
        dev = None
        if device is not None:
            dev = torch.device(device)
        elif requested != "host":
            # the card unless filter_backend says cpu; raises without one
            dev = pick_device(params.filter_backend)
        self.backend = resolve_map_backend(requested, dev.type if dev is not None else None)
        self.device = dev if self.backend == "fused" else None
        self.cfg = map_config_from_params(
            params, beams or DEFAULT_BEAMS,
            platform=self.device.type if self.device is not None else None,
        )
        self._lock = threading.Lock()
        self._states: Optional[MapState] = None     # fused: device state
        self._states_np: Optional[dict] = None      # host: stacked numpy arrays
        self.reset()
        self.ticks = 0
        self.dispatch_count = 0
        self.matches = 0
        self.last_estimates: list[Optional[PoseEstimate]] = [None] * streams
        self.last_inputs: Optional[tuple] = None  # (points, masks, live)

    # -- state construction -------------------------------------------------

    def _fresh_np(self) -> dict:
        g = self.cfg.grid
        return {
            "log_odds": np.zeros((self.streams, g, g), np.int32),
            "pose": np.zeros((self.streams, 3), np.int32),
            "origin_xy": np.zeros((self.streams, 2), np.float32),
            "revision": np.zeros((self.streams,), np.int32),
        }

    def reset(self) -> None:
        """Cold reset of every stream's map and pose (on the device in
        place once the state exists: no new memory in a guarded loop)."""
        with self._lock:
            if self.backend == "fused" and self._states is not None:
                for k in STATE_KEYS:
                    getattr(self._states, k).zero_()  # MapState.create's zeros
            elif self.backend == "fused":
                self._states = MapState.create(self.cfg, self.streams, self.device)
            else:
                self._states_np = self._fresh_np()

    def precompile(self) -> None:
        """One warm tick on a throwaway state: on the card this builds and
        loads the matcher kernels (and the allocator's pools), so the first
        live tick does not pay for them.  No-op on the host backend."""
        if self.backend != "fused":
            return
        b = self.cfg.beams
        fleet_map_match_step(
            MapState.create(self.cfg, self.streams, self.device),
            torch.zeros((self.streams, b, 2), dtype=torch.float32, device=self.device),
            torch.zeros((self.streams, b), dtype=torch.bool, device=self.device),
            torch.zeros((self.streams,), dtype=torch.int32, device=self.device),
            self.cfg,
        )

    # -- hot path -----------------------------------------------------------

    def submit(self, outputs: Sequence) -> list[Optional[PoseEstimate]]:
        """One fleet tick from chain outputs: ``outputs[i]`` is stream i's
        newest FilterOutput (None = idle: its map and pose pass through).
        Returns one Optional[PoseEstimate] per stream."""
        if len(outputs) != self.streams:
            raise ValueError(f"expected {self.streams} outputs, got {len(outputs)}")
        b = self.cfg.beams
        points = np.zeros((self.streams, b, 2), np.float32)
        masks = np.zeros((self.streams, b), bool)
        live = np.zeros((self.streams,), np.int32)
        for i, out in enumerate(outputs):
            if out is None:
                continue
            xy = np.asarray(out.points_xy, np.float32)
            if xy.shape != (b, 2):
                raise ValueError(f"stream {i}: points {xy.shape} != beam grid ({b}, 2)")
            points[i] = xy
            masks[i] = np.asarray(out.point_mask, bool)
            live[i] = 1
        return self.submit_points(points, masks, live)

    def submit_points(self, points: np.ndarray, masks: np.ndarray,
                      live: np.ndarray) -> list[Optional[PoseEstimate]]:
        """Lower-level tick: stream-stacked (N, B, 2) float32 endpoints,
        (N, B) validity and (N,) live flags.  One fused device step (one
        host fetch of the wire rows), or N host-reference steps."""
        points = np.asarray(points, np.float32)
        masks = np.asarray(masks, bool)
        live = np.asarray(live, np.int32)
        self.last_inputs = (points, masks, live)
        with self._lock:
            self.ticks += 1
            if self.backend == "fused":
                dev = self.device
                with guards.declared_sync():  # the tick's three uploads
                    inputs = (torch.from_numpy(points).to(dev), torch.from_numpy(masks).to(dev),
                              torch.from_numpy(live).to(dev))
                _, wires = fleet_map_match_step(self._states, *inputs, self.cfg)
                self.dispatch_count += 1
                # one device->host copy per tick: the wires and the revisions
                with guards.declared_sync():
                    host = torch.cat([wires, self._states.revision[:, None]],
                                     dim=1).cpu().numpy()
                wires, revs = host[:, :5], host[:, 5]
            else:
                from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import map_match_step_np

                st = self._states_np
                wires = np.zeros((self.streams, 5), np.int32)
                for i in range(self.streams):
                    new_state, wires[i] = map_match_step_np(
                        {k: st[k][i] for k in STATE_KEYS}, points[i], masks[i], int(live[i]),
                        self.cfg,
                    )
                    for k in STATE_KEYS:
                        st[k][i] = new_state[k]
                revs = st["revision"]
        estimates: list[Optional[PoseEstimate]] = []
        for i in range(self.streams):
            if not live[i]:
                estimates.append(None)
                continue
            pose_q = wires[i, :3].astype(np.int32)
            x, y, th = pose_to_metric(pose_q, self.cfg)
            est = PoseEstimate(
                x_m=x, y_m=y, theta_rad=th, score=int(wires[i, 3]),
                matched_points=int(wires[i, 4]), revision=int(revs[i]), pose_q=pose_q,
            )
            estimates.append(est)
            self.last_estimates[i] = est
            if est.score > 0:
                self.matches += 1
        return estimates

    # -- checkpoint surface (the JAX package's format) ----------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Host copy of every stream's MapState plus the schema
        ``version`` key; the same format on both backends and in both
        packages."""
        with self._lock:
            if self.backend == "fused":
                snap = self._states.to_numpy()
            else:
                snap = {k: v.copy() for k, v in self._states_np.items()}
        snap["version"] = np.asarray(MAP_STATE_VERSION, np.int32)
        return snap

    @staticmethod
    def _shape_mismatch(snap: dict, streams: int, grid: int) -> Optional[tuple[dict, dict]]:
        expected = {k: (streams, *v) for k, v in MapState.shapes(grid).items()}
        got = {k: tuple(np.asarray(v).shape) for k, v in snap.items() if k != "version"}
        return None if expected == got else (got, expected)

    @staticmethod
    def _row_ok(snap: dict, grid: int) -> bool:
        """Version and shapes of one stream's row snapshot (logged when
        rejected)."""
        if not FleetMapper._version_ok(snap, "stream map snapshot"):
            return False
        expected = MapState.shapes(grid)
        got = {k: tuple(np.asarray(v).shape) for k, v in snap.items() if k != "version"}
        if expected != got:
            log.warning("rejecting incompatible stream map snapshot (%s != %s)", got, expected)
            return False
        return True

    @classmethod
    def snapshot_compatible(cls, params, snap: dict, streams: int = 1) -> bool:
        """Would a mapper built from ``params`` accept this snapshot?
        Host-side, no device work."""
        if int(np.asarray(snap.get("version", -1))) != MAP_STATE_VERSION:
            return False
        return cls._shape_mismatch(snap, streams, int(params.map_grid)) is None

    @staticmethod
    def _version_ok(snap: dict, what: str) -> bool:
        if int(np.asarray(snap.get("version", -1))) == MAP_STATE_VERSION:
            return True
        log.warning("rejecting %s with schema version %s (want %d)", what,
                    snap.get("version"), MAP_STATE_VERSION)
        return False

    def restore(self, snap: Optional[dict]) -> bool:
        """Restore a snapshot (either package's), or cold-reset when None.
        A version or geometry mismatch is rejected with the live state
        untouched (returns False)."""
        if snap is None:
            self.reset()
            return False
        if not self._version_ok(snap, "map snapshot"):
            return False
        mismatch = self._shape_mismatch(snap, self.streams, self.cfg.grid)
        if mismatch is not None:
            log.warning("rejecting incompatible map snapshot (%s != %s)", *mismatch)
            return False
        with self._lock:
            if self.backend == "fused":
                self._states = MapState.from_numpy(snap, self.device)
            else:
                self._states_np = {
                    k: np.array(snap[k], dtype=v.dtype) for k, v in self._fresh_np().items()
                }
        return True

    # -- per-stream checkpoint surface --------------------------------------

    def _check_stream(self, i: int) -> None:
        if not (0 <= i < self.streams):
            raise IndexError(f"stream {i} out of range [0, {self.streams})")

    def snapshot_stream(self, i: int) -> dict:
        """One stream's MapState row, schema-versioned like the full
        snapshot (a row copy from the device on the fused backend)."""
        self._check_stream(i)
        with self._lock:
            if self.backend == "fused":
                with guards.declared_sync():  # the row's copy to the host
                    snap = {k: getattr(self._states, k)[i].cpu().numpy().copy()
                            for k in STATE_KEYS}
            else:
                snap = {k: self._states_np[k][i].copy() for k in STATE_KEYS}
        snap["version"] = np.asarray(MAP_STATE_VERSION, np.int32)
        return snap

    def restore_stream(self, i: int, snap: dict) -> bool:
        """Install a :meth:`snapshot_stream` row into stream ``i``, every
        other stream untouched; a version or geometry mismatch is rejected
        with the live state untouched."""
        self._check_stream(i)
        if not self._row_ok(snap, self.cfg.grid):
            return False
        with self._lock:
            for k in STATE_KEYS:
                row = np.asarray(snap[k], STATE_DTYPES[k])
                if self.backend == "fused":
                    with guards.declared_sync():  # the row's upload
                        getattr(self._states, k)[i].copy_(torch.from_numpy(row.copy()))
                else:
                    self._states_np[k][i] = row
        return True

    def reanchor_stream(self, i: int, pose_q) -> None:
        """Re-anchor stream ``i``'s pose (clipped into the map, heading
        wrapped) with the map grid and every other stream untouched."""
        self._check_stream(i)
        pose = clamp_pose_q(pose_q, self.cfg)
        with self._lock:
            if self.backend == "fused":
                with guards.declared_sync():
                    self._states.pose[i].copy_(torch.from_numpy(pose))
            else:
                self._states_np["pose"][i] = pose

    # -- sharded checkpoints ------------------------------------------------

    def save_sharded(self, path: str) -> None:
        """Persist the fused backend's stacked MapState with
        torch.distributed.checkpoint (utils/checkpoint_sharded — the
        checkpointer is schema-agnostic, so MapState rides the same
        save/rotate machinery as FilterState).  Host-backend states go
        through snapshot()+npz."""
        if self.backend != "fused":
            raise RuntimeError(
                "save_sharded needs the fused backend (host states "
                "checkpoint via snapshot() + utils/checkpoint)"
            )
        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded

        with self._lock:
            state = {k: getattr(self._states, k).clone() for k in STATE_KEYS}
        checkpoint_sharded.save_sharded(path, state)

    def load_sharded(self, path: str) -> bool:
        """Restore a :meth:`save_sharded` checkpoint onto this mapper's
        device; absence or another geometry is rejected with the live state
        untouched.  The template is the fused backend's fresh state as meta
        tensors (no allocation)."""
        if self.backend != "fused":
            raise RuntimeError("load_sharded needs the fused backend")
        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded

        template = MapState.create(self.cfg, self.streams, "meta")
        got = checkpoint_sharded.restore_sharded(path, template, device=self.device)
        if got is None:
            return False
        with self._lock:
            self._states = MapState(**got)
        return True


class CarriedFleetMapper:
    """The mapper face of the fused mapping route: the per-stream MapState
    lives in the fleet ingest state (FleetFusedIngest's ``map_*`` planes)
    and the match + update run inside its tick, so this class dispatches
    nothing (``dispatch_count`` stays 0).  Every consumer that speaks
    FleetMapper — the loop-closure engine's tap, the quarantine
    checkpoints, /diagnostics — works unchanged against the carried map:

      * :meth:`absorb_wires` turns the engine's per-tick map wires
        (``take_map_wires``) into the PoseEstimates the host route's
        ``submit_points`` would have returned, and keeps the reconstructed
        sweeps as ``last_inputs`` for the loop tap;
      * the checkpoint surface (full and per stream) reads and writes the
        carry in FleetMapper's keys and schema version, so the two routes'
        map checkpoints interoperate byte for byte;
      * :meth:`reanchor_stream` rewrites the carried pose row.

    ``submit``/``submit_points`` raise: the route has no mapper step.

    On a mesh of several stream rows the engine holds each row's map planes
    on the row's lead card; its wires, recons and map snapshots come back
    in global stream order, so this face reads the fleet as one."""

    backend = "carried"

    def __init__(self, params, engine, *, beams: Optional[int] = None) -> None:
        if engine._mapping is None:
            raise ValueError(
                "CarriedFleetMapper needs an engine built with the fused "
                "mapping route active (fused_mapping_backend='fused' + map_enable)"
            )
        self.engine = engine
        self.streams = engine.streams
        self.cfg: MapConfig = engine._mapping
        self.device = engine.device
        if beams is not None and beams != self.cfg.beams:
            raise ValueError(f"carried mapper beams {self.cfg.beams} != service beams {beams}")
        self.ticks = 0
        self.dispatch_count = 0  # mapping rides the ingest steps
        self.matches = 0
        self.last_estimates: list[Optional[PoseEstimate]] = [None] * self.streams
        self.last_inputs: Optional[tuple] = None

    def precompile(self) -> None:
        """No-op: the map update is part of the ingest step, warmed by
        FleetFusedIngest.precompile."""

    # -- hot path (fed by the service from the engine's wires) -------------

    def submit(self, outputs) -> list:
        raise RuntimeError(
            "the carried mapper has no submit path: mapping runs inside the "
            "fused ingest step (absorb_wires consumes its wires)"
        )

    def submit_points(self, points, masks, live) -> list:
        raise RuntimeError(
            "the carried mapper has no submit path: mapping runs inside the "
            "fused ingest step (absorb_wires consumes its wires)"
        )

    def absorb_wires(self, wires: list, recons: list) -> list[Optional[PoseEstimate]]:
        """One service tick of the fused route: ``wires`` is the engine's
        ``take_map_wires()`` drain, ``recons`` its ``take_recon()``.  One
        Optional[PoseEstimate] per stream — None where no mapping tick was
        parsed or the parsed tick's ``live`` flag is 0 (an idle tick never
        republishes the previous pose) — and the reconstructed endpoints
        kept as ``last_inputs``, the scan window the carried matcher saw."""
        if len(wires) != self.streams or len(recons) != self.streams:
            raise ValueError(
                f"expected {self.streams} wires + recons, got {len(wires)}/{len(recons)}"
            )
        self.last_inputs = recon_input_planes(recons, self.streams, self.cfg.beams)
        self.ticks += 1
        estimates: list[Optional[PoseEstimate]] = []
        for i, w in enumerate(wires):
            if w is None or int(w[0]) == 0:
                estimates.append(None)
                continue
            pose_q = np.asarray(w[1:4], np.int32)
            x, y, th = pose_to_metric(pose_q, self.cfg)
            est = PoseEstimate(
                x_m=x, y_m=y, theta_rad=th, score=int(w[4]), matched_points=int(w[5]),
                revision=int(w[6]), pose_q=pose_q,
            )
            estimates.append(est)
            self.last_estimates[i] = est
            if est.score > 0:
                self.matches += 1
        return estimates

    # -- checkpoint surface (FleetMapper's formats over the carry) ---------

    def reset(self) -> None:
        """Cold reset of every stream's carried map and pose."""
        g = self.cfg.grid
        self.engine.map_restore({
            "log_odds": np.zeros((self.streams, g, g), np.int32),
            "pose": np.zeros((self.streams, 3), np.int32),
            "origin_xy": np.zeros((self.streams, 2), np.float32),
            "revision": np.zeros((self.streams,), np.int32),
        })
        self.last_estimates = [None] * self.streams

    def snapshot(self) -> dict[str, np.ndarray]:
        snap = self.engine.map_snapshot()
        snap["version"] = np.asarray(MAP_STATE_VERSION, np.int32)
        return snap

    def restore(self, snap: Optional[dict]) -> bool:
        """Restore a FleetMapper-format snapshot into the carry, or
        cold-reset when None; a version or geometry mismatch is rejected
        with the carry untouched."""
        if snap is None:
            self.reset()
            return False
        if not FleetMapper._version_ok(snap, "map snapshot"):
            return False
        if FleetMapper._shape_mismatch(snap, self.streams, self.cfg.grid) is not None:
            log.warning("rejecting incompatible carried-map snapshot")
            return False
        self.engine.map_restore({k: np.asarray(snap[k]) for k in STATE_KEYS})
        return True

    def snapshot_stream(self, i: int) -> dict:
        snap = self.engine.map_snapshot_stream(i)
        snap["version"] = np.asarray(MAP_STATE_VERSION, np.int32)
        return snap

    def restore_stream(self, i: int, snap: dict) -> bool:
        if not FleetMapper._row_ok(snap, self.cfg.grid):
            return False
        self.engine.map_restore_stream(i, {k: np.asarray(snap[k]) for k in STATE_KEYS})
        return True

    def reanchor_stream(self, i: int, pose_q) -> None:
        self.engine.map_reanchor_stream(i, clamp_pose_q(pose_q, self.cfg))
