"""Multi-stream filter service — the production face of the sharded step.

The PyTorch counterpart of the JAX package's ``ShardedFilterService``
(its ``parallel/service.py``).  One process, many lidars (a multi-sensor
rig or a fleet gateway): each stream keeps its own rolling window/voxel
state, all hosted on one ``(stream, beam)`` mesh (parallel/sharding.py).
Per tick the service stacks every stream's newest revolution into one
count-embedded ``(streams, 3, N+1)`` upload, runs the one batched sharded
step — ONE median launch a mesh block (B1, or B2 for ``inc``) — and hands
back per-stream host outputs from ONE device->host copy of the tick's flat
output wires.  On a mesh held in this process with several blocks (by
default every visible card) each block's stream rows go up to its own
device, the blocks' voxel partials are summed in the process, and the
outputs come together in global stream and beam order on the lead card.

Where the JAX package donates the state to its compiled step, the state
here is updated in place under ``self._lock`` (as ``ScanFilterChain``
does), so :meth:`snapshot` copies under the lock.  Snapshots keep the
JAX package's format (stream-batched numpy arrays keyed by FilterState
field, the derived ``median_sorted`` excluded and recomputed), so a fleet
window carries across the two packages.

The byte seams (:meth:`submit_bytes`, :meth:`submit_bytes_backlog`) run
the host decode + lockstep tick, or driver/ingest.FleetFusedIngest built
on this service's mesh: over a mesh of several stream rows each row's
streams run on the row's lead block (the JAX package's ``P("stream",
...)`` placement, a row computed once rather than replicated over its beam
devices), and the engine's outputs, wires and checkpoints come back in
global stream order.  The SLAM back-end stays on the lead card and reads
the other rows' results as declared host reads; the SLAM seams feed mapping/mapper.FleetMapper (or, on the fused mapping
route, read the map carried in the fused ingest state through
CarriedFleetMapper), slam/loop.LoopClosureEngine and
mapping/worldmap.WorldMap.  The health supervisor (driver/health.py,
:meth:`attach_health`) masks sick streams onto idle lanes and moves their
rows to a checkpoint and back.

:class:`ElasticFleetService` is the failover pod over several such services
(shards): placement, shard supervision, per-stream snapshots, evacuation on
shard loss and re-admission, one dispatch a tick per shard.

Both serve the scheduled seam too (``attach_scheduler``, ``offer_bytes``,
``drain_scheduled``, ``scheduler_status``): parallel/scheduler.TrafficShaper
admits arrivals into bounded per-stream queues and picks each drain's rung
and bucket; the pod adds work stealing, the autoscaler and one shared world
map.  ``save_sharded``/``load_sharded`` write and read this process's
block of the state with torch.distributed.checkpoint
(utils/checkpoint_sharded.py), resharding onto another mesh shape.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES
from rplidar_ros2_driver_tpu_torch.filters.chain import (
    DEFAULT_BEAMS,
    config_from_params,
    pick_device,
    resolve_fleet_ingest_backend,
)
from rplidar_ros2_driver_tpu_torch.mapping.mapper import resolve_fused_mapping_backend
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    FilterOutput,
    FilterState,
    _unpack_compact,
    pack_host_scan_counted,
    recompute_median_sorted,
    unpack_output_wire,
)
from rplidar_ros2_driver_tpu_torch.parallel import multihost
from rplidar_ros2_driver_tpu_torch.parallel.sharding import (
    STATE_SPEC,
    _filter_step_shard,
    _shard_of,
    _visible_cards,
    abstract_sharded_state,
    block_states,
    create_sharded_state,
    gather_state,
    make_mesh,
    place_state,
    pod_groups,
    step_blocks,
)
from rplidar_ros2_driver_tpu_torch.utils.fetch import bounded_fetch

logger = logging.getLogger("rplidar_tpu.service")


def _tick_wire(out: FilterOutput) -> torch.Tensor:
    """One tick's (streams, 5*B + G*G) float32 output wires: per stream
    the flat layout of ops/filters._pack_output_wire (voxel counts exact
    to 2^24), so ops/filters.unpack_output_wire reads each row."""
    s = out.ranges.shape[0]
    return torch.cat([
        out.ranges,
        out.intensities,
        out.points_xy.reshape(s, -1),
        out.point_mask.to(torch.float32),
        out.voxel.reshape(s, -1).to(torch.float32),
    ], dim=1)


class _TickFetch:
    """One tick's output wires on their way to the host: the host tensor
    they land in and, on CUDA, the event recorded after the non-blocking
    copy into a recycled pinned buffer (returned to ``pool`` once read)."""

    def __init__(self, host: torch.Tensor, event, pool: Optional[list]) -> None:
        self.host = host
        self.event = event
        self.pool = pool

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()

    def release(self) -> None:
        if self.pool is not None:
            self.pool.append(self.host)
            self.pool = None


class ShardedFilterService:
    """Many lidars' filter chains on one ``(stream, beam)`` mesh: one
    batched tick for the whole fleet (see the module docstring).

    The lockstep step splits each stream row over its beam blocks.  The
    fused byte ingest (``fleet_ingest_backend='fused'``) has no beam split:
    its engine places each stream row's streams — decode carries, filter
    rows, sub-sweep cache, carried map — on the row's lead block ``(r,
    0)``, which stages, runs and lands that row's part of every tick.  The
    JAX package replicates such a row over the row's beam devices; here it
    is computed once, and the row's other blocks hold none of it."""

    def __init__(
        self,
        params: DriverParams,
        streams: int,
        *,
        mesh=None,
        beams: int = DEFAULT_BEAMS,
        capacity: int = MAX_SCAN_NODES,
        fleet_ingest_buckets: Optional[tuple] = None,
        staging_pool=None,
    ) -> None:
        from rplidar_ros2_driver_tpu_torch.utils.backend import maybe_enable_compilation_cache

        maybe_enable_compilation_cache(getattr(params, "compilation_cache_dir", None))
        if mesh is None:
            # a multi-process topology (the coordinator variables) joins
            # the process group first, so the default mesh spans every
            # process; single-process it spans every visible card (the
            # (1, 1) host mesh on filter_backend cpu)
            multihost.initialize()
            dev = pick_device(params.filter_backend)
            mesh = make_mesh(device=dev if dev.type == "cpu" else None)
        self.mesh = mesh
        self.device = mesh.device
        self.params = params
        self.cfg = config_from_params(params, beams, platform=self.device.type)
        self.streams = streams
        self.capacity = capacity
        # bound on tick collects (see _collect_pending); 0/None = unbounded
        self.collect_timeout_s = params.collect_timeout_s
        self._shards = [_shard_of(v, self.cfg) for v in mesh.blocks]
        self._local = mesh.local_streams(streams)
        # the rows of the upload each block's device gets (one block: all)
        self._block_rows = ([v.local_streams(streams) for v in mesh.blocks] if mesh.multi_block
                            else [slice(None)])
        self._step = self._step_packed
        # the step updates the state in place: ticks, snapshots and
        # restores in THIS process serialize on this lock.  In
        # multi-process mode collective operations (ticks) must
        # additionally be issued in the same order by every process — a
        # local mutex cannot order collectives across processes.
        self._lock = threading.Lock()
        self._state = create_sharded_state(mesh, self.cfg, streams)
        # (fetch, live-mask, collector name) of the newest dispatched tick
        # not yet collected (submit_pipelined); _epoch advances on every
        # restore so a failed tick cannot re-stash pre-restore outputs
        self._pending = None
        self._epoch = 0
        self._cuda = self.device.type == "cuda"
        # pinned staging of the upload (reused once its copies landed: one
        # event a block) and a pool of pinned output buffers (returned
        # once read)
        self._in_host: dict = {}
        self._in_done: list = []
        self._out_pool: list = []
        # raw-bytes tick seam: resolved once, engines built lazily
        self.fleet_ingest_backend = resolve_fleet_ingest_backend(
            getattr(params, "fleet_ingest_backend", "auto"), self.device.type
        )
        self.fused_mapping_backend = resolve_fused_mapping_backend(
            getattr(params, "fused_mapping_backend", "auto"), self.device.type
        )
        self.fleet_ingest = None        # FleetFusedIngest (fused backend)
        self._fleet_ingest_buckets = fleet_ingest_buckets
        # the host's shared StagingPool (the serving pod injects one per
        # host); None: the engine owns a private pool
        self._staging_pool = staging_pool
        self._host_ingest = None        # per-stream (decoder, latest-slot)
        self.host_scans_dropped = 0     # newest-wins drops on the host path
        # SLAM front-end seam: each materialized tick feeds one mapper
        # tick; per-stream pose estimates land in ``last_poses``
        self.mapper = None
        self.last_poses: list = [None] * streams
        # SLAM back-end seam: every mapper tick is observed by the loop
        # engine; statuses in ``last_loop``, corrected poses beside them
        self.loop = None
        self.last_loop: list = [None] * streams
        self.last_corrected_poses: list = [None] * streams
        # shared-world mapping seam: finalized submaps fuse into one
        # fleet-wide accumulation
        self.world = None
        # fault-tolerance seam (driver/health.FleetHealth): quarantined
        # streams are masked onto idle lanes, their rows checkpointed at
        # quarantine and restored at rejoin (see attach_health)
        self.health = None
        self.stream_checkpoints: dict = {}
        self.quarantines = 0
        self.rejoins = 0
        # while a double-buffered scheduled drain is in flight: the streams
        # whose quarantine checkpoints wait for the drain's idle half
        # (drain_scheduled sets and flushes it; None = checkpoint inline)
        self._defer_checkpoints: Optional[list] = None
        # traffic-shaping seam (parallel/scheduler.TrafficShaper): bounded
        # per-stream admission queues and the rung picked per drain
        self.scheduler = None
        if getattr(params, "health_enable", False):
            self.attach_health()

    # -- the step -----------------------------------------------------------

    def _step_packed(self, state, packed):
        """The counted compact ingest: the (streams, 3, N+1) upload with
        each stream's node count in its reserved last slot, unpacked on
        the device, then the batched sharded step (state in place).  On a
        mesh of several blocks ``state`` and ``packed`` are lists, one
        entry a block."""
        if not self.mesh.multi_block:
            count = packed[:, 0, -1].to(torch.int32) & 0xFFFF
            return _filter_step_shard(state, _unpack_compact(packed, count), self.cfg,
                                      self._shards[0])
        batches = [_unpack_compact(p, p[:, 0, -1].to(torch.int32) & 0xFFFF) for p in packed]
        return step_blocks(self.mesh, self.cfg, state, batches, self._shards)

    def _upload(self, packed_np: np.ndarray):
        """The packed uint16 block on the device, as int16 (same bytes);
        on a mesh of several blocks, each block's stream rows on its own
        device.  On CUDA through a pinned staging buffer, reused once the
        previous upload has landed.  Called under the lock."""
        wire = torch.from_numpy(packed_np.view(np.int16))
        blocks = self.mesh.blocks
        if not self._cuda:
            return [wire[r] for r in self._block_rows] if self.mesh.multi_block else wire
        for done in self._in_done:
            done.synchronize()
        buf = self._in_host.get(wire.shape)
        if buf is None:
            buf = self._in_host[wire.shape] = torch.empty(
                wire.shape, dtype=torch.int16, pin_memory=True)
        buf.copy_(wire)
        ups = [buf[r].to(v.device, non_blocking=True) for r, v in zip(self._block_rows, blocks)]
        self._in_done = []
        for dev in dict.fromkeys(v.device for v in blocks):
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            self._in_done.append(done)
        return ups if self.mesh.multi_block else ups[0]

    def _start_fetch(self, wire: torch.Tensor) -> _TickFetch:
        """Start the one device->host copy of a tick's output wires."""
        if not self._cuda:
            return _TickFetch(wire, None, None)
        host = None
        while self._out_pool and host is None:
            cand = self._out_pool.pop()
            if cand.shape == wire.shape:
                host = cand
        if host is None:
            host = torch.empty(wire.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(wire, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _TickFetch(host, event, self._out_pool)

    # graftlint: hot-loop (one upload through the recycled pinned staging
    # + one step per tick; allocation lives in _stack's packing, which the
    # wire contract zero-pads per tick)
    def _dispatch(self, packed_np: np.ndarray, stash=None) -> _TickFetch:
        """Upload, step and start the fetch of one tick under the lock;
        ``stash`` = (live, collector) makes it the pending tick in the
        same critical section (a restore cannot slip in between)."""
        with self._lock:
            packed = self._upload(packed_np)
            self._state, out = self._step(self._state, packed)
            fetch = self._start_fetch(_tick_wire(out))
            if stash is not None:
                self._pending = (fetch, *stash)
            return fetch

    def _single_controller(self, what: str) -> None:
        if self.mesh.spans_processes:
            raise RuntimeError(
                f"{what} needs one controller that addresses every shard; on "
                "a mesh that spans processes each process feeds its own "
                "streams with submit_local"
            )

    def precompile(self) -> None:
        """Build the tick's kernels and run the batched step once now, so
        the first live tick doesn't stall on them.  Zero-count step +
        rollback like the chain: on a FRESH state the all-idle tick writes
        only values the state already holds and the cursor/filled advance
        is undone; a state that has absorbed scans skips the warmup."""
        with self._lock:
            if any(bool(st.filled.any()) for st in block_states(self._state)):
                return
        packed_np = self._stack([None] * (self._local.stop - self._local.start))
        with self._lock:
            packed = self._upload(packed_np)
            self._state, _ = self._step(self._state, packed)
            for st in block_states(self._state):
                st.cursor.zero_()
                st.filled.zero_()
            if self._cuda:
                for dev in dict.fromkeys(v.device for v in self.mesh.blocks):
                    torch.cuda.synchronize(dev)

    # -- SLAM seams ---------------------------------------------------------

    def attach_mapper(self, mapper=None) -> "object":
        """Attach a FleetMapper (built here from this service's params
        when not given) so each tick's outputs run the SLAM front-end:
        per-stream correlative scan-to-map match + log-odds map update,
        one mapper tick per filter tick.  Idle streams pass through.
        Returns the attached mapper (its snapshot/restore surface is the
        caller's to drive, like ``fleet_ingest``'s).

        With the fused mapping route (``fused_mapping_backend='fused'``)
        the attached face is a CarriedFleetMapper: the MapState rides the
        fleet ingest state, the match + update run inside its tick, and
        this service feeds the face from the engine's wires
        (:meth:`_map_tick_fused`) — the same checkpoint formats and loop
        tap, no mapper step."""
        if mapper is None and self.fused_mapping_backend == "fused":
            from rplidar_ros2_driver_tpu_torch.mapping.mapper import CarriedFleetMapper

            self._ensure_byte_ingest()
            mapper = CarriedFleetMapper(self.params, self.fleet_ingest, beams=self.cfg.beams)
        elif mapper is None:
            from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

            mapper = FleetMapper(
                self.params, self.streams, beams=self.cfg.beams, device=self.device
            )
        elif self.fused_mapping_backend == "fused" and not hasattr(mapper, "absorb_wires"):
            # a dispatching FleetMapper beside the in-carry map would
            # keep a SECOND diverging map per stream — refuse loudly
            raise ValueError(
                "this service resolved fused_mapping_backend='fused' "
                "(the map rides the ingest carry); attach no mapper, or "
                "a CarriedFleetMapper over this service's engine"
            )
        if mapper.streams != self.streams:
            raise ValueError(
                f"mapper has {mapper.streams} streams, service has {self.streams}"
            )
        # build and warm the matcher kernels NOW: the first live tick
        # must never stall on them
        if mapper.backend == "fused":
            mapper.precompile()
        self.mapper = mapper
        if self.health is not None:
            # health came first (health_enable): warm the mapper's row
            # checkpoint too, before live traffic
            self._warm_quarantine_path()
        return mapper

    def attach_loop_closure(self, engine=None) -> "object":
        """Attach a LoopClosureEngine (built here from this service's
        params when not given) so every mapper tick runs the SLAM
        back-end: submap lifecycle, batched loop-closure candidate
        matching and the pose-graph correction (slam/loop.py).  Requires
        an attached mapper (attached here when there is none).  Returns
        the attached engine."""
        if self.mapper is None:
            self.attach_mapper()
        if engine is None:
            from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine

            engine = LoopClosureEngine(self.params, self.mapper)
        if engine.streams != self.streams:
            raise ValueError(
                f"loop engine has {engine.streams} streams, service has {self.streams}"
            )
        # build and warm the check/install kernels NOW (the mapper's
        # precompile discipline)
        engine.precompile()
        self.loop = engine
        if self.world is not None:
            # the world consumes the engine's finalization product from
            # here on (one quantize path; the cadence pull retires)
            engine.on_install = self._world_install
        return engine

    def _loop_tick(self) -> None:
        """Feed the attached loop engine this mapper tick's estimates
        (no-op without one); stashes per-stream statuses + corrected
        poses."""
        if self.loop is None:
            return
        self.last_loop = self.loop.observe(self.last_poses)
        self.last_corrected_poses = [
            None if est is None else self.loop.corrected_pose_q(i, est.pose_q)
            for i, est in enumerate(self.last_poses)
        ]

    def loop_status(self) -> Optional[dict]:
        """The /diagnostics loop-closure value group's payload (None
        when no engine is attached)."""
        return None if self.loop is None else self.loop.status()

    def attach_world_map(self, world=None) -> "object":
        """Attach the shared-world mapping plane (built here from this
        service's params when not given): finalized per-stream submaps
        are aligned against the world reference and fused into ONE
        device-resident int32 accumulation.  Requires an attached mapper;
        with a loop engine attached the world consumes the engine's OWN
        finalization product through its ``on_install`` tap, otherwise
        the world pulls row snapshots at its ``world_merge_revs``
        cadence.  Returns the attached world."""
        if self.mapper is None:
            self.attach_mapper()
        if world is None:
            from rplidar_ros2_driver_tpu_torch.mapping.worldmap import (
                WorldMap,
                world_config_from_params,
            )

            world = WorldMap(world_config_from_params(self.params, self.mapper.cfg),
                             device=self.device)
        world.precompile()
        self.world = world
        if self.loop is not None:
            self.loop.on_install = self._world_install
        return world

    def _world_install(self, i: int, plane, anchor) -> None:
        """The loop engine's finalization tap: the exact quantized
        plane the submap library stored fuses into the world."""
        if self.world is not None:
            self.world.ingest_submap(i, plane, anchor)

    def _world_tick(self) -> None:
        """Feed the attached world map (no-op without one).  With a loop
        engine the merges already arrived through its ``on_install`` tap;
        without one, streams whose revolution count crossed the
        ``world_merge_revs`` cadence contribute a row snapshot quantized
        through the ONE finalization path (mapping/submap)."""
        if self.world is None or self.loop is not None:
            return
        from rplidar_ros2_driver_tpu_torch.mapping.submap import quantize_submap_plane

        for i, est in enumerate(self.last_poses):
            if est is None:
                continue
            rev = int(est.revision)
            if self.world.merge_due(i, rev):
                snap = self.mapper.snapshot_stream(i)
                plane = quantize_submap_plane(snap["log_odds"], self.mapper.cfg)
                self.world.ingest_submap(i, plane, snap["pose"])
                self.world.note_merged(i, rev)

    def world_status(self) -> Optional[dict]:
        """The /diagnostics "World Map" value group's payload (None
        when no world is attached)."""
        return None if self.world is None else self.world.status()

    def _map_tick(self, outs: list) -> list:
        """Feed one materialized tick to the attached mapper (no-op
        without one); stashes the per-stream estimates."""
        if self.mapper is None or outs is None:
            return outs
        self.last_poses = self.mapper.submit(outs)
        self._loop_tick()
        self._world_tick()
        return outs

    def _map_tick_recon(self) -> None:
        """The de-skew/reconstruction mapper seam: feed the attached
        mapper this tick's FRESH reconstructed sweeps
        (FleetFusedIngest.take_recon) instead of waiting for completed
        revolutions — one mapper update per data tick per stream.
        Streams with no fresh reconstruction pass through idle."""
        if self.mapper is None or self.fleet_ingest is None:
            return
        recons = self.fleet_ingest.take_recon()
        if not any(r is not None for r in recons):
            # no fresh reconstruction anywhere: an idle tick must never
            # republish the previous tick's poses as current
            self.last_poses = [None] * self.streams
            return
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import recon_input_planes

        points, masks, live = recon_input_planes(recons, self.streams, self.cfg.beams)
        self.last_poses = self.mapper.submit_points(points, masks, live)
        self._loop_tick()
        self._world_tick()

    def _map_tick_fused(self) -> None:
        """The fused mapping seam: the map update already ran inside this
        tick's ingest step, so nothing is launched here.  The engine's
        fresh map wires and reconstructed sweeps become per-stream
        PoseEstimates (CarriedFleetMapper.absorb_wires) and the loop tap
        sees the scan window the carried matcher saw.  A tick with no
        live wire anywhere lands ``last_poses = [None] * streams``."""
        if self.mapper is None or self.fleet_ingest is None:
            return
        wires = self.fleet_ingest.take_map_wires()
        recons = self.fleet_ingest.take_recon()
        self.last_poses = self.mapper.absorb_wires(wires, recons)
        if any(p is not None for p in self.last_poses):
            self._loop_tick()
            self._world_tick()

    # -- fault tolerance ----------------------------------------------------

    def attach_health(self, health=None, *, clock=None, probes=None,
                      record_masks: bool = False, warm: bool = True) -> "object":
        """Attach a FleetHealth supervisor (built from this service's
        ``health_*`` params when not given) over the byte seams: each
        ``submit_bytes`` tick is observed per stream, quarantined streams
        are masked onto the idle lanes (the same fleet step, unchanged
        shapes), and the quarantine/rejoin transitions drive this
        service's per-stream checkpoints (filter, map and loop rows
        snapshotted at quarantine, restored at rejoin).

        ``probes`` maps stream index -> device-health callable polled at
        quarantine release; ``clock`` injects a time source for tests.
        ``warm`` runs one snapshot/restore round trip of stream 0 on the
        fresh engines before live traffic (skipped once traffic flowed)."""
        from rplidar_ros2_driver_tpu_torch.driver.health import FleetHealth, HealthConfig

        self._ensure_byte_ingest()
        if health is None:
            import time as _time

            health = FleetHealth(
                self.streams, HealthConfig.from_params(self.params),
                clock=clock or _time.monotonic, probes=probes, record_masks=record_masks,
            )
        elif clock is not None or probes or record_masks:
            # construction-only kwargs ignored on an explicit instance
            # would drop the caller's probes — refuse instead
            raise ValueError(
                "clock/probes/record_masks only apply when attach_health "
                "builds the supervisor; configure the passed FleetHealth "
                "directly (set_probe, record_masks at construction)"
            )
        if health.streams != self.streams:
            raise ValueError(
                f"health supervisor has {health.streams} streams, service has {self.streams}"
            )
        # the checkpoint machinery binds to the transition hooks; hooks the
        # caller installed on an explicit instance are chained after
        user_quarantine = health.on_quarantine
        user_recover = health.on_recover

        def on_quarantine(i: int) -> None:
            self._quarantine_stream(i)
            if user_quarantine is not None:
                user_quarantine(i)

        def on_recover(i: int) -> None:
            self._rejoin_stream(i)
            if user_recover is not None:
                user_recover(i)

        health.on_quarantine = on_quarantine
        health.on_recover = on_recover
        self.health = health
        if warm:
            self._warm_quarantine_path()
        return health

    def _warm_quarantine_path(self) -> None:
        """One snapshot/restore round trip of stream 0 per engine, before
        live traffic only (the restore resets stream 0's decode carries):
        the rejoin path's first run happens here, not mid-stream."""
        eng = self.fleet_ingest
        if eng is not None and eng.ticks == 0:
            eng.restore_stream(0, eng.snapshot_stream(0))
            # a fresh engine's carries are zero: clearing the flag gives
            # back the exact pre-warmup state
            eng._reset_next[0] = False
        if self.mapper is not None and self.mapper.ticks == 0:
            self.mapper.restore_stream(0, self.mapper.snapshot_stream(0))
        if self.loop is not None and self.loop.ticks == 0:
            self.loop.restore_stream(0, self.loop.snapshot_stream(0))

    def _quarantine_stream(self, i: int) -> None:
        """Health hook: stream i just entered QUARANTINED — freeze its rows
        (fused ingest decode + filter rows, map row, loop row) in the
        schema-versioned per-stream formats.  Host-backend fleets have no
        per-stream device rows to freeze; masking alone degrades them."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import is_carried

        if self._defer_checkpoints is not None:
            # a double-buffered scheduled drain is dispatching: the pull
            # rides its idle half (drain_scheduled's overlap hook).  The
            # lane was masked for this drain — an idle row passes its
            # carries through — so the deferred snapshot equals an inline
            # one
            self._defer_checkpoints.append(i)
            return
        snap: dict = {}
        if self.fleet_ingest is not None:
            snap["ingest"] = self.fleet_ingest.snapshot_stream(i)
        if self.mapper is not None and not is_carried(self.mapper):
            # on the carried route the map rows already ride
            # snap["ingest"] (v3 keys): no second pull of the same planes
            snap["map"] = self.mapper.snapshot_stream(i)
        if self.loop is not None:
            snap["loop"] = self.loop.snapshot_stream(i)
        self.stream_checkpoints[i] = snap
        self.quarantines += 1
        logger.warning("stream %d quarantined (state checkpointed)", i)

    def _rejoin_stream(self, i: int) -> None:
        """Health hook: stream i's backoff + probe gate released it —
        restore its quarantine checkpoint (filter window and map intact,
        decode carries reset for the mid-capsule re-entry) before this
        tick's bytes flow again."""
        snap = self.stream_checkpoints.pop(i, None)
        if snap:
            if "ingest" in snap and self.fleet_ingest is not None:
                self.fleet_ingest.restore_stream(i, snap["ingest"])
            if "map" in snap and self.mapper is not None:
                self.mapper.restore_stream(i, snap["map"])
            if "loop" in snap and self.loop is not None:
                self.loop.restore_stream(i, snap["loop"])
        self.rejoins += 1
        logger.info("stream %d rejoining (state restored from checkpoint)", i)

    def health_status(self) -> Optional[list]:
        """Per-stream health dicts for /diagnostics-style reporting (None
        when no supervisor is attached)."""
        return None if self.health is None else self.health.status()

    # -- traffic-shaping seam ----------------------------------------------

    def attach_scheduler(self, shaper=None) -> "object":
        """Attach a TrafficShaper (built from this service's
        ``sched_*``/``admission_*`` params when not given) over the byte
        seam: :meth:`offer_bytes` admits arrivals into bounded per-stream
        queues (the oldest tick shed past the cap) and
        :meth:`drain_scheduled` drains the whole backlog at the rung the
        shaper picks from its depth.  Fused backend only, and BEFORE
        precompile and traffic: every ladder rung must be warmed (the
        engine refuses late extensions).  Returns the shaper."""
        from rplidar_ros2_driver_tpu_torch.parallel.scheduler import (
            SchedulerConfig,
            TrafficShaper,
        )

        self._ensure_byte_ingest()
        if self.fleet_ingest_backend != "fused":
            raise ValueError(
                "attach_scheduler needs fleet_ingest_backend='fused' "
                "(the rung ladder is a set of warmed super-step drain "
                "depths; the host path has none)"
            )
        if shaper is None:
            shaper = TrafficShaper(self.streams, SchedulerConfig.from_params(self.params))
        if shaper.streams != self.streams:
            raise ValueError(
                f"shaper has {shaper.streams} streams, service has {self.streams}"
            )
        self.fleet_ingest.ensure_rungs(shaper.cfg.rungs)
        self.scheduler = shaper
        return shaper

    def offer_bytes(self, items) -> None:
        """Admit one wall tick of arrivals into the shaper's bounded
        per-stream queues (``items[i]``: None, one ``(ans_type, frames)``
        data tick, or a LIST of data ticks — a reconnect storm delivers
        several at once).  Nothing dispatches here."""
        if self.scheduler is None:
            raise RuntimeError("attach_scheduler() first")
        self.scheduler.offer_tick(items)

    def drain_scheduled(self) -> list[list[FilterOutput]]:
        """Drain the whole admitted backlog at the rung the shaper picks
        from its depth — ``ceil(depth/rung)`` dispatches — and feed the
        measured wall time back into the per-(rung, bucket) latency model.
        The bucket ladder's pick (with ``bucket_rungs``) becomes the
        engine's slicing cap first; quarantine checkpoints the masking
        triggers, and a due world-map publication, ride the idle half of
        the double buffer.  Returns the :meth:`submit_bytes_backlog`
        per-stream lists (all empty when nothing was queued; the ladder
        still observes the empty drain)."""
        if self.scheduler is None:
            raise RuntimeError("attach_scheduler() first")
        eng = self.fleet_ingest
        if eng is not None and eng.warmup_costs:
            # precompile's timed runs seed the cost table once; the first
            # live measurement of each key replaces its seed
            self.scheduler.model.seed_many(eng.warmup_costs)
            eng.warmup_costs = {}
        ticks, rung = self.scheduler.drain_plan(0, range(self.streams))
        if not ticks:
            # nothing queued: no pose is current this tick
            self.last_poses = [None] * self.streams
            return [[] for _ in range(self.streams)]
        bucket = self.scheduler.bucket_plan(0)
        if bucket is not None:
            eng.set_active_bucket(bucket)
        deferred: Optional[list] = None
        if eng is not None and eng.double_buffer and self.health is not None:
            deferred = []
            self._defer_checkpoints = deferred
        # a due tile publication rides the same idle half: host work from
        # one declared fetch of the accumulation, no dispatch
        overlapped_world = self.world is not None and eng is not None and eng.double_buffer
        world_pub = self.world.overlap_hook() if overlapped_world else None

        def _overlap(deferred=deferred, world_pub=world_pub) -> None:
            self._defer_checkpoints = None
            while deferred:
                self._quarantine_stream(deferred.pop(0))
            if world_pub is not None:
                world_pub()

        t0 = time.perf_counter()
        try:
            outs = self.submit_bytes_backlog(
                ticks, rung=rung,
                overlap_work=_overlap if deferred is not None or world_pub is not None else None,
            )
        finally:
            self._defer_checkpoints = None
            while deferred:
                # the drain raised before its overlap hook: checkpoint now
                # — a deferred checkpoint is never dropped
                self._quarantine_stream(deferred.pop(0))
        self.scheduler.note_drain(0, len(ticks), time.perf_counter() - t0, rung=rung,
                                  bucket=eng.slicing_bucket)
        if self.world is not None and not overlapped_world and self.world.tick():
            # single-buffered engine: publish in the epilogue
            self.world.publish()
        return outs

    # graftlint: read-path
    def scheduler_status(self) -> Optional[dict]:
        """The /diagnostics scheduler value group's payload (None when no
        shaper is attached), with the engine's rung and staging counters."""
        if self.scheduler is None:
            return None
        status = self.scheduler.status()
        status["rung_dispatches"] = ({} if self.fleet_ingest is None
                                     else dict(self.fleet_ingest.rung_dispatches))
        if self.fleet_ingest is not None:
            eng = self.fleet_ingest
            status["rung_bucket_dispatches"] = {
                f"T{r}xM{b}": n for (r, b), n in sorted(eng.rung_bucket_dispatches.items())
            }
            status["staging_overlap_hits"] = eng.staging_overlap_hits
        return status

    # -- raw-bytes ingest seam ----------------------------------------------

    def _ensure_byte_ingest(self):
        """Build the resolved fleet ingest backend's engine(s) lazily."""
        if self.fleet_ingest_backend == "fused":
            if self.fleet_ingest is None:
                from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest

                kw = {"buckets": self._fleet_ingest_buckets} if self._fleet_ingest_buckets else {}
                self.fleet_ingest = FleetFusedIngest(
                    self.params, self.streams, mesh=self.mesh,
                    beams=self.cfg.beams, capacity=self.capacity,
                    staging_pool=self._staging_pool, **kw,
                )
            return
        if getattr(self.params, "deskew_enable", False):
            # the sub-sweep cache lives inside the fused step's device
            # state; the host decode path cannot run it — refuse loudly
            raise ValueError(
                "deskew_enable requires the fused fleet ingest backend; "
                f"this service resolved fleet_ingest_backend="
                f"{self.fleet_ingest_backend!r} — pin it to 'fused' "
                "(the host decode path has no device-resident sub-sweep "
                "cache to reconstruct from)"
            )
        if self._host_ingest is None:
            from rplidar_ros2_driver_tpu_torch.driver.assembly import ScanAssembler
            from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder

            latest: list = [None] * self.streams
            decs = []
            for i in range(self.streams):
                def keep(scan, i=i):
                    if latest[i] is not None:
                        self.host_scans_dropped += 1
                    latest[i] = dict(scan)

                decs.append(BatchScanDecoder(ScanAssembler(max_nodes=self.capacity,
                                                           on_complete=keep)))
            self._host_ingest = (decs, latest)

    def _host_decode_tick(self, items) -> list:
        """The golden fleet byte path: per-stream host decode + assembly,
        newest completed revolution per stream (older completions within
        one tick are counted in ``host_scans_dropped``)."""
        decs, latest = self._host_ingest
        for i, item in enumerate(items):
            if not item:
                continue
            ans, frames = item
            decs[i].on_measurement_batch(int(ans), list(frames))
        scans = []
        for i in range(self.streams):
            scans.append(latest[i])
            latest[i] = None
        return scans

    def submit_bytes(self, items, *, pipelined: bool = False) -> list[Optional[FilterOutput]]:
        """One fleet tick from RAW FRAME BYTES: ``items[i]`` is
        ``(ans_type, [(payload, rx_monotonic_ts), ...])`` for stream i
        (None = idle this tick).  Backend per ``fleet_ingest_backend``:

          * host  — per-stream BatchScanDecoder + ScanAssembler here,
            newest revolution per stream into the one batched
            :meth:`submit` / :meth:`submit_pipelined` tick (ONE median
            launch for the fleet).
          * fused — driver/ingest.FleetFusedIngest: every stream's bytes
            to filter outputs in one step per tick.

        Returns one Optional[FilterOutput] per stream — the NEWEST
        completed revolution's output this tick.  The backends' window
        semantics differ by design: the host path is the lockstep tick
        (an idle stream's window absorbs an all-masked scan), the fused
        path is N independent chains (a stream advances only on its own
        completed revolutions).  The fused path's checkpoint surface is
        ``self.fleet_ingest.snapshot()/restore()``."""
        if len(items) != self.streams:
            raise ValueError(f"expected {self.streams} per-stream byte runs, got {len(items)}")
        self._ensure_byte_ingest()
        if self.health is not None:
            # release polls first (a rejoining stream's checkpoint restores
            # before its bytes flow), then quarantined streams mask to None
            items = self.health.begin_tick(items)
        result = self._submit_bytes_tick(items, pipelined)
        if self.health is not None:
            # the observations close the loop (pipelined: the previous
            # tick's completions, one tick of staleness in the view too)
            self.health.end_tick(result)
        return result

    def _submit_bytes_tick(self, items, pipelined: bool) -> list[Optional[FilterOutput]]:
        if self.fleet_ingest_backend == "fused":
            outs = (self.fleet_ingest.submit_pipelined(items) if pipelined
                    else self.fleet_ingest.submit(items))
            result = [o[-1][0] if o else None for o in outs]
            if self.fleet_ingest._mapping is not None:
                # fused mapping route: the map update already ran inside
                # the ingest step — surface its wires
                self._map_tick_fused()
                return result
            if self.fleet_ingest._deskew is not None:
                # reconstruction active: the mapper consumes the
                # every-tick reconstructed sweeps, not the once-per-
                # revolution chain outputs (which still publish)
                self._map_tick_recon()
                return result
            return self._map_tick(result)
        scans = self._host_decode_tick(items)
        if pipelined:
            return self.submit_pipelined(scans)
        if all(s is None for s in scans):
            # no stream completed a revolution: nothing to advance (the
            # synchronous byte tick is edge-triggered)
            return [None] * self.streams
        return self.submit(scans)

    def submit_bytes_pipelined(self, items) -> list[Optional[FilterOutput]]:
        """Pipelined :meth:`submit_bytes` (one tick of declared
        staleness; the publish never waits on this tick's compute)."""
        return self.submit_bytes(items, pipelined=True)

    def submit_bytes_backlog(
        self, ticks, *, rung: Optional[int] = None, overlap_work=None,
    ) -> list[list[FilterOutput]]:
        """The catch-up seam: drain a BACKLOG of queued fleet byte ticks
        in one call (``ticks``: a list of :meth:`submit_bytes` item
        lists).  Backend per ``fleet_ingest_backend``:

          * fused — FleetFusedIngest.submit_backlog: up to
            ``super_tick_max`` ticks per super-step, exact against
            submitting the ticks one by one.
          * host — the golden reference: each tick through the host
            decode + the one batched lockstep tick.

        Returns one list per stream holding EVERY completed revolution's
        FilterOutput across the backlog, in tick order.

        ``rung`` overrides the drain's super-tick depth with another
        warmed ladder rung (fused backend only — the scheduler's pick).
        ``overlap_work`` (fused only) runs on the idle half of the double
        buffer: after the drain's dispatches are issued, before their
        results are parsed."""
        self._ensure_byte_ingest()
        if rung is not None and self.fleet_ingest_backend != "fused":
            raise ValueError(
                "a drain rung override needs the fused fleet ingest "
                "backend (the host path dispatches per tick — there is "
                "no super-step depth to pick)"
            )
        if overlap_work is not None and self.fleet_ingest_backend != "fused":
            raise ValueError(
                "overlap_work needs the fused fleet ingest backend "
                "(the host path has no async dispatch window for the "
                "work to overlap with)"
            )
        if self.health is not None:
            # masking only: a catch-up drain is one event, not len(ticks)
            # ticks of evidence — the FSMs advance on live ticks
            ticks = [self.health.mask(t) for t in ticks]
        if self.fleet_ingest_backend == "fused":
            outs = self.fleet_ingest.submit_backlog(ticks, rung=rung,
                                                    overlap_work=overlap_work)
            results = [[o for (o, _ts0, _dur) in s] for s in outs]
            if self.fleet_ingest._mapping is not None:
                # fused mapping route: every drained tick's map update ran
                # inside the steps, in tick order; the wires drained here
                # are the newest tick's, the poses current at drain end
                self._map_tick_fused()
                return results
            if self.mapper is not None and self.fleet_ingest._deskew is not None:
                # reconstruction active: a catch-up drain collapses to
                # ONE mapper update per stream — the newest sweep
                self._map_tick_recon()
                return results
            if self.mapper is not None:
                # feed the drained revolutions to the mapper in
                # per-stream order (mapper streams are independent, so
                # each stream's map sees exactly its own sequence)
                for k in range(max((len(s) for s in results), default=0)):
                    self._map_tick([s[k] if len(s) > k else None for s in results])
            return results
        results: list[list[FilterOutput]] = [[] for _ in range(self.streams)]
        for items in ticks:
            if len(items) != self.streams:
                raise ValueError(
                    f"expected {self.streams} per-stream byte runs, got {len(items)}"
                )
            scans = self._host_decode_tick(items)
            if all(s is None for s in scans):
                continue  # edge-triggered, like submit_bytes
            for i, out in enumerate(self.submit(scans)):
                if out is not None:
                    results[i].append(out)
        return results

    # -- ingest -------------------------------------------------------------

    def _stack(
        self, scans: Sequence[Optional[dict]], offset: int = 0, malformed: str = "raise",
    ) -> np.ndarray:
        """Pack a block of streams' newest revolutions; ``offset`` is the
        block's first global stream index (error attribution only).

        ``malformed="idle"`` turns a scan that fails to pack (oversized,
        mismatched field lengths, ...) into an all-masked idle row plus a
        warning instead of raising — submit_local uses this because a
        per-process exception ahead of the collective hangs every peer
        inside theirs."""
        n = self.capacity
        packed = np.zeros((len(scans), 3, n + 1), np.uint16)  # +1: count slot
        for i, scan in enumerate(scans):
            if scan is None:
                continue  # stream idle this tick: all-masked scan (count 0)
            try:
                packed[i] = pack_host_scan_counted(
                    scan["angle_q14"], scan["dist_q2"], scan["quality"],
                    scan.get("flag"), n,
                )
            except (ValueError, KeyError, TypeError) as e:
                # KeyError/TypeError: missing wire field / None where an
                # array is required — same per-tick-data class as oversize
                if malformed == "idle":
                    # packed[i] is untouched: the row stays the all-zero
                    # all-masked idle frame
                    logger.warning(
                        "stream %d: dropping malformed scan this tick: %s", offset + i, e,
                    )
                    continue
                raise type(e)(f"stream {offset + i}: {e}") from None
        return packed

    def _clip_to_capacity(self, scan: Optional[dict]) -> Optional[dict]:
        """Truncate an oversized scan to ``capacity`` nodes, keeping the
        head — the assembler's overflow policy."""
        wire_keys = ("angle_q14", "dist_q2", "quality", "flag")
        try:
            lens = {len(scan[k]) for k in wire_keys[:3]} | (
                {len(scan["flag"])} if scan.get("flag") is not None else set())
            if len(lens) != 1 or lens.pop() <= self.capacity:
                # mismatched field lengths are the malformed-scan signal:
                # pass through UNclipped so _stack's malformed="idle"
                # handler reports and drops it
                return scan
        except (KeyError, TypeError):
            # missing/None wire field: likewise _stack's problem — this
            # helper must never raise ahead of the collective
            return scan
        n = self.capacity
        return {k: (v[:n] if k in wire_keys and v is not None else v) for k, v in scan.items()}

    def submit(self, scans: Sequence[Optional[dict]]) -> list[Optional[FilterOutput]]:
        """One tick: newest revolution per stream (None = no new data).

        An idle stream still advances its window cursor with an all-masked
        scan, keeping every stream's state in lock-step — the property
        that makes the one stacked tick possible.  Returns per-stream numpy
        FilterOutputs (None for idle streams)."""
        if len(scans) != self.streams:
            raise ValueError(f"expected {self.streams} scans, got {len(scans)}")
        self._single_controller("submit")
        fetch = self._dispatch(self._stack(scans))
        live = [s is not None for s in scans]
        return self._map_tick(bounded_fetch(
            lambda: self._materialize(fetch, live),
            self.collect_timeout_s,
            "fleet tick materialize (device->host)",
        ))

    def _materialize(self, fetch: _TickFetch, live: Sequence[bool]) -> list[Optional[FilterOutput]]:
        """Wait for one tick's output wires (one device->host copy for the
        whole fleet) and split them into per-stream numpy FilterOutputs
        (None for idle streams)."""
        wires = fetch.wait()
        results: list[Optional[FilterOutput]] = [
            unpack_output_wire(wires[i], self.cfg) if is_live else None
            for i, is_live in enumerate(live)
        ]
        fetch.release()  # the unpack copied every row out of the buffer
        return results

    # graftlint: hot-loop
    def submit_pipelined(self, scans: Sequence[Optional[dict]]) -> list[Optional[FilterOutput]]:
        """Fleet analog of ScanFilterChain.process_raw_pipelined: dispatch
        THIS tick's step, return the PREVIOUS tick's per-stream outputs —
        one tick of declared staleness in exchange for a publish that
        never waits on device compute (the previous tick's device->host
        copy started at its own dispatch).  The previous tick is collected
        BEFORE this tick's upload.  Returns all-None on the first tick;
        :meth:`flush_pipelined` drains the last tick when the fleet stops.
        Single-controller only, like :meth:`submit`."""
        if len(scans) != self.streams:
            raise ValueError(f"expected {self.streams} scans, got {len(scans)}")
        self._single_controller("submit_pipelined")
        packed_np = self._stack(scans)
        with self._lock:
            pending, self._pending = self._pending, None
            epoch = self._epoch
        prev = None
        if pending is not None:
            try:
                prev = self._collect_pending(pending)
            except Exception:
                # the fetch of the previous tick itself failed: re-stash
                # it so flush_pipelined can retry instead of losing it
                self._restash_pending(pending, epoch)
                raise
        try:
            self._dispatch(packed_np, stash=([s is not None for s in scans], "_materialize"))
        except Exception:
            # this tick's upload/dispatch failed after the previous tick
            # was popped: re-stash it so flush_pipelined can still drain it
            if pending is not None:
                self._restash_pending(pending, epoch)
            raise
        with self._lock:
            if self._epoch != epoch:
                # a restore raced in after the pop: the popped tick is
                # pre-restore and must not be published
                prev = None
        if prev is not None:
            return self._map_tick(prev)
        return [None] * self.streams

    def _restash_pending(self, pending, epoch: int) -> None:
        """Put a popped-but-unpublished tick back for the drain — unless a
        restore moved the epoch meanwhile or a newer dispatch already
        stashed its own."""
        with self._lock:
            if self._pending is None and self._epoch == epoch:
                self._pending = pending

    def _collect_pending(self, pending) -> list[Optional[FilterOutput]]:
        """Materialize a stashed tick via the collector it was stashed
        with (``_materialize`` or ``_collect_local``), resolved by NAME at
        collect time; bounded by ``collect_timeout_s``."""
        fetch, live, collect = pending
        return bounded_fetch(
            lambda: getattr(self, collect)(fetch, live),
            self.collect_timeout_s,
            "fleet tick collect (device->host)",
        )

    def discard_pipelined(self) -> None:
        """Drop the pending pipelined tick without fetching it."""
        with self._lock:
            self._pending = None

    def flush_pipelined(self) -> Optional[list[Optional[FilterOutput]]]:
        """Collect the last dispatched tick's outputs (the ones still in
        flight when the fleet stops), or None.  After pipelined LOCAL
        ticks this returns only this process's stream block.  On a fetch
        fault the tick is re-stashed so a later flush can retry, and the
        error surfaces to the caller."""
        with self._lock:
            pending, self._pending = self._pending, None
            epoch = self._epoch
        if pending is None:
            return None
        try:
            outs = self._collect_pending(pending)
        except Exception:
            self._restash_pending(pending, epoch)
            raise
        if pending[2] == "_materialize":
            # the run's final in-flight tick feeds the mapper like every
            # steady-state tick did; local ticks skip the (single-
            # controller) mapper seam
            return self._map_tick(outs)
        return outs

    def submit_local(self, local_scans: Sequence[Optional[dict]]) -> list[Optional[FilterOutput]]:
        """Multi-controller tick: each process feeds ONLY its own stream
        block (multihost.local_stream_slice) and gets back only its own
        streams' outputs.  Collective: every process calls it each tick,
        in the same order relative to other collectives.  Needs the
        stream-major mesh of ``multihost.make_global_mesh`` with a beam
        extent of 1 where the mesh spans processes (each process's rows
        then live on its own device); single-process it behaves like
        :meth:`submit`.

        Oversized scans are truncated to ``capacity`` (head-keep) and
        malformed ones become idle rows, rather than raised: a
        per-process error before the collective would leave every peer
        blocked inside theirs.  A stream-count mismatch still raises — a
        deployment bug that fails on every process identically."""
        local_scans, packed_local = self._pack_local(local_scans)
        fetch = self._dispatch(packed_local)
        live = [s is not None for s in local_scans]
        return bounded_fetch(
            lambda: self._collect_local(fetch, live),
            self.collect_timeout_s,
            "fleet tick collect (device->host)",
        )

    def _pack_local(self, local_scans: Sequence[Optional[dict]]) -> tuple[list, np.ndarray]:
        """Shared ingest prologue of the local tick variants: validate
        the block, clip to capacity, pack (malformed scans degrade to idle
        rows).  Returns the clipped scans and the packed local block."""
        slc = multihost.local_stream_slice(self.streams)
        if self.mesh.spans_processes and self.mesh.shape["beam"] > 1:
            raise RuntimeError(
                "submit_local needs each process's stream rows whole on its "
                "own device; a beam axis that spans processes splits them — "
                "use the stream-major mesh of multihost.make_global_mesh with "
                "a beam extent of 1"
            )
        if slc != self._local:
            raise RuntimeError(
                f"this process feeds streams {slc.start}:{slc.stop} but holds "
                f"{self._local.start}:{self._local.stop} — use the stream-major "
                "mesh of multihost.make_global_mesh"
            )
        n_local = slc.stop - slc.start
        if len(local_scans) != n_local:
            raise ValueError(
                f"expected {n_local} local scans (streams {slc.start}:{slc.stop} "
                f"of {self.streams}), got {len(local_scans)}"
            )
        local_scans = [self._clip_to_capacity(s) for s in local_scans]
        return local_scans, self._stack(local_scans, offset=slc.start, malformed="idle")

    def _collect_local(self, fetch: _TickFetch, live: list[bool]) -> list[Optional[FilterOutput]]:
        """Materialize THIS process's stream block of a tick: its rows are
        whole on its own device (see submit_local), so this touches no
        peer — never a collective, processes may collect at different
        times."""
        return self._materialize(fetch, live)

    def submit_local_pipelined(
        self, local_scans: Sequence[Optional[dict]]
    ) -> list[Optional[FilterOutput]]:
        """Pipelined multi-controller tick: dispatch THIS tick's
        collective step, return the PREVIOUS tick's outputs for this
        process's stream block.  Every process must use the pipelined
        variant together, in the same order relative to other
        collectives.

        A previous-tick collect failure is logged and the tick dropped
        (returning all-None) instead of raised — raising before this
        tick's dispatch would leave every peer blocked inside the
        collective.  Dispatch failures still raise (every peer observes
        the collective die)."""
        local_scans, packed_local = self._pack_local(local_scans)
        n_local = len(local_scans)
        with self._lock:
            pending, self._pending = self._pending, None
            epoch = self._epoch
        prev = None
        if pending is not None:
            try:
                prev = self._collect_pending(pending)
            except Exception:
                # dropping beats hanging the fleet: the slot is about to
                # be taken by this tick's output
                logger.warning("dropping previous pipelined tick (collect failed)",
                               exc_info=True)
                prev = None
        try:
            self._dispatch(packed_local,
                           stash=([s is not None for s in local_scans], "_collect_local"))
        except Exception:
            # the collective dispatch died: re-stash so flush_pipelined
            # can still drain the prior tick (its host copy is intact)
            if pending is not None:
                self._restash_pending(pending, epoch)
            raise
        with self._lock:
            if self._epoch != epoch:
                prev = None
        return prev if prev is not None else [None] * n_local

    # -- checkpoint surface (mirrors ScanFilterChain's) ---------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Host copy of every stream's window and accumulator, in the JAX
        package's format (stream-batched numpy arrays; the derived
        ``median_sorted`` excluded).  The device copy is taken under the
        lock, the host copy after it."""
        self._single_controller("snapshot")
        return gather_state(self.mesh, self._copy_state())

    def _copy_state(self):
        """A device copy of this process's block of the state, taken under
        the lock (on a mesh of several blocks, a list of every block's);
        the derived ``median_sorted`` excluded, so the checkpoint format is
        the same for every median backend."""
        with self._lock:
            copies = [
                {f.name: getattr(st, f.name).clone()
                 for f in dataclasses.fields(FilterState) if f.name != "median_sorted"}
                for st in block_states(self._state)
            ]
        return copies if self.mesh.multi_block else copies[0]

    def save_sharded(self, path: str) -> None:
        """Persist the sharded state with torch.distributed.checkpoint — no
        host gather: each process writes its own block
        (utils/checkpoint_sharded.py).  Use this instead of snapshot()+npz
        once the fleet state stops fitting comfortably in one host buffer.

        Collective: in a mesh that spans processes EVERY process must call
        this, and every process must sequence its submit()/save_sharded()
        calls in the same global order (e.g. checkpoint between ticks from
        the same control loop) — the internal lock only orders threads
        within one process, and mismatched collectives deadlock the mesh.
        """
        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded

        if self.mesh.multi_block:
            # the blocks held in this process, put together on the host:
            # the global layout a (1, 1) mesh writes
            whole = {k: torch.from_numpy(v)
                     for k, v in gather_state(self.mesh, self._copy_state()).items()}
            checkpoint_sharded.save_sharded(path, whole)
            return
        checkpoint_sharded.save_sharded(path, self._copy_state(), mesh=self.mesh,
                                        specs=STATE_SPEC)

    def load_sharded(self, path: str) -> bool:
        """Restore a sharded checkpoint directly onto this service's mesh
        (saved on any mesh shape with the same global geometry).  Absence
        or a geometry mismatch is rejected with the current state left
        untouched; returns whether the restore happened.  The template is
        abstract (meta tensors): no throwaway device state is allocated."""
        from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded

        template = abstract_sharded_state(self.mesh, self.cfg, self.streams)
        if self.mesh.multi_block:
            # the global state on the host, then each block's part of it
            got = checkpoint_sharded.restore_sharded(path, template, device="cpu")
            state = None if got is None else place_state(
                self.mesh, {**got, "median_sorted": None}, beams=self.cfg.beams)
        else:
            got = checkpoint_sharded.restore_sharded(path, template, mesh=self.mesh,
                                                     specs=STATE_SPEC)
            state = None if got is None else FilterState(**{**got, "median_sorted": None})
        if state is None:
            return False
        if self.cfg.median_backend.startswith("inc"):
            # the derived sorted window, recomputed on each block (the sort
            # runs along the unsharded window axis)
            for st in block_states(state):
                st.median_sorted = recompute_median_sorted(st.range_window)
        with self._lock:
            self._state = state
            self._pending = None  # pre-restore outputs: never publish
            self._epoch += 1
        return True

    def restore(self, snap: Optional[dict[str, np.ndarray]]) -> bool:
        """Restore a :meth:`snapshot` (either package's), or reset when
        None.  A geometry mismatch is rejected with the current state
        untouched.  The upload copies the snapshot's arrays (a CPU
        tensor would otherwise share the caller's buffers)."""
        if snap is not None:
            expected = {
                k: (self.streams, *v)
                for k, v in FilterState.shapes(
                    self.cfg.window, self.cfg.beams, self.cfg.grid).items()
            }
            got = {
                k: tuple(np.asarray(v).shape)
                for k, v in snap.items()
                if k != "median_sorted"  # derived, never carried
            }
            if expected != got:
                logger.warning("rejecting incompatible sharded snapshot (%s != %s)",
                               got, expected)
                return False
            core = {k: v for k, v in snap.items() if k != "median_sorted"}
            restored = place_state(self.mesh, {**core, "median_sorted": None},
                                   beams=self.cfg.beams)
            if self.cfg.median_backend.startswith("inc"):
                for st in block_states(restored):
                    st.median_sorted = recompute_median_sorted(st.range_window)
            with self._lock:
                self._state = restored
                self._pending = None
                self._epoch += 1
            return True
        fresh = create_sharded_state(self.mesh, self.cfg, self.streams)
        with self._lock:
            self._state = fresh
            self._pending = None
            self._epoch += 1
        return False


# ---------------------------------------------------------------------------
# the failover pod (elastic fleet of fleets)
# ---------------------------------------------------------------------------


def _pod_cards(params: DriverParams) -> list:
    """The devices a pod built with ``mesh=None`` splits into its groups:
    every visible card, or the host with ``filter_backend: cpu``."""
    dev = pick_device(params.filter_backend)
    return [dev] if dev.type == "cpu" else _visible_cards()


class ElasticFleetService:
    """Fleet of fleets: ``streams`` lidars spread over S *shards*, each shard
    one fused engine pair (FleetFusedIngest + mapper behind a
    :class:`ShardedFilterService`) built for a fixed lane count — and the pod
    survives losing a whole shard, not just a noisy stream.  The JAX
    package's ``ElasticFleetService``, its per-tick seam:

      * **placement** — parallel/sharding.FleetTopology maps streams onto
        shard lanes.  Lanes beyond the hosted streams are idle padding lanes
        of the same fleet state, so every membership change (evacuate,
        rebalance) relabels live lanes: nothing is rebuilt and no shape
        changes, which utils/guards.steady_state pins across the whole kill
        -> evacuate -> re-admit cycle;
      * **shard supervision** — driver/health.ShardHealth per shard, above
        the per-stream FSM: a raised dispatch or a chaos kill is LOST at
        once; fleet-wide tick starvation walks UP -> SUSPECT -> LOST;
        re-admission is gated on capped backoff plus a probe;
      * **evacuation** — the per-stream schema-versioned snapshots
        (``snapshot_stream`` of the ingest engine and the mapper) are pulled
        every ``failover_snapshot_ticks`` into a host store; on shard loss
        every victim's filter and map rows are restored from its last
        snapshot into a surviving shard's idle lane BEFORE bytes flow, decode
        carries reset.  Ticks the dead shard absorbed after the last
        snapshot are lost and recorded per stream in :meth:`replay_plan`.

    A lost shard's engines are wiped (``cold_reset``, in place) the moment it
    dies, so a re-admission rebuilds from snapshots, never from stale device
    state; on re-admission streams migrate back through fresh live
    snapshots.

    Placement: with ``mesh=None`` the pod's cards (every visible card, or
    the host with ``filter_backend: cpu``) split into the JAX pod's groups
    (``groups``, from
    :func:`~rplidar_ros2_driver_tpu_torch.parallel.sharding.pod_groups`:
    ``cards // shards`` cards a shard, round-robin one each when there are
    fewer cards than shards): a shard loss is its group dropping out of the
    pod.  A shard computes on its group's lead card alone: its work is its
    fused engines, which JAX replicates over the group (a ``stream = 1``
    mesh) and the port runs once; the group's other cards hold no state
    and do no work.  A given ``mesh`` serves every shard.  A stream
    crosses cards only as host arrays (its snapshot rows, restored onto the
    destination lane's card).  Each host of ``hosts``
    owns one StagingPool that its shards' engines share, whatever their
    cards.  Single controller.

    Beside the per-tick seam (:meth:`submit_bytes`) the pod serves the
    scheduled seam: :meth:`attach_scheduler` (one pod-level TrafficShaper,
    one rung ladder per shard), :meth:`offer_bytes` and
    :meth:`drain_scheduled` — with cross-shard work stealing (a sibling
    drains a deep shard's whole queues on borrowed idle lanes) and the
    byte-rate autoscaler (park a shard on thin occupancy, unpark it on
    pressure) — and one pod-level shared world (:meth:`attach_world_map`)
    fused from every shard's finalized submaps."""

    def __init__(
        self,
        params: DriverParams,
        streams: int,
        *,
        shards: Optional[int] = None,
        lanes: Optional[int] = None,
        hosts: Optional[int] = None,
        mesh=None,
        beams: int = DEFAULT_BEAMS,
        capacity: int = MAX_SCAN_NODES,
        fleet_ingest_buckets: Optional[tuple] = None,
        clock=None,
        probes: Optional[dict] = None,
    ) -> None:
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardHealth, ShardHealthConfig
        from rplidar_ros2_driver_tpu_torch.driver.ingest import StagingPool
        from rplidar_ros2_driver_tpu_torch.parallel.sharding import FleetTopology

        if shards is None:
            shards = int(getattr(params, "shard_count", 1))
        if lanes is None:
            lanes = int(getattr(params, "shard_lanes", 0))
        if hosts is None:
            hosts = int(getattr(params, "pod_hosts", 1))
        if lanes == 0:
            # the smallest lane count that survives one whole shard loss
            # ((shards-1)*lanes >= streams); a single-shard pod gets no
            # failover headroom (there is nowhere to evacuate to)
            lanes = streams if shards == 1 else -(-streams // (shards - 1))
        self.params = params
        self.streams = streams
        self.topology = FleetTopology(streams, shards, lanes, hosts=hosts)
        self.clock = clock or time.monotonic
        # the cards of each shard (indices into _pod_cards; None with a
        # given mesh): JAX's groups, each shard's one-card mesh on its lead
        self.groups = None
        if mesh is None:
            cards = _pod_cards(params)
            self.groups = pod_groups(shards, len(cards))
            meshes = [make_mesh(device=cards[group[0]]) for group in self.groups]
        else:
            meshes = [mesh] * shards
        self.meshes = meshes
        # one staging pool per HOST, owned by the pod and shared by the
        # engines of its shards, whatever their cards (pinned when they run
        # on a card; a pair goes back only once its own card read it)
        pin = meshes[0].device.type == "cuda"
        self.staging_pools = [StagingPool(pin=pin) for _ in range(hosts)]
        self.shards = [
            ShardedFilterService(
                params, lanes, mesh=meshes[s], beams=beams, capacity=capacity,
                fleet_ingest_buckets=fleet_ingest_buckets,
                staging_pool=self.staging_pools[self.topology.host_of(s)],
            )
            for s in range(shards)
        ]
        for sh in self.shards:
            if sh.fleet_ingest_backend != "fused":
                raise ValueError(
                    "ElasticFleetService needs fleet_ingest_backend='fused' "
                    "(the per-stream device rows are the snapshot/migration "
                    "unit; the host backend has none)"
                )
        probes = probes or {}
        cfg = ShardHealthConfig.from_params(params)
        self.shard_health = [
            ShardHealth(cfg, s, clock=self.clock, probe=probes.get(s)) for s in range(shards)
        ]
        self.snapshot_ticks = int(getattr(params, "failover_snapshot_ticks", 8))
        self.tick_no = 0
        self.chaos = None                   # driver/chaos.ShardChaosSchedule
        self._chaos_probe_wired = False
        # per-stream snapshot store: stream -> (tick, {"ingest"[, "map"]})
        self._snap: dict = {}
        self._fresh_snap = None             # the fresh-lane rows
        # replay-plan bookkeeping: ticks absorbed since each stream's last
        # snapshot (lost if its shard dies), decode-reset ticks, lost ticks
        self._since_snap: list[list[int]] = [[] for _ in range(streams)]
        self._resets: list[set] = [set() for _ in range(streams)]
        self._excluded: list[set] = [set() for _ in range(streams)]
        # counters and the event/evacuation logs (the diagnostics surface)
        self.evacuations = 0
        self.migrations = 0
        self.readmits = 0
        self.shard_evacuations = [0] * shards
        self.shard_migrations_in = [0] * shards
        self.shard_last_migration_tick: list = [None] * shards
        self.last_migration_tick: Optional[int] = None
        self.streams_lost_unhosted = 0
        self.events: list[tuple] = []
        self.evacuation_log: list[dict] = []
        self.last_evacuation: Optional[dict] = None
        self._first_tick_pending = False
        self.last_poses: list = [None] * streams
        # the scheduled seam (attach_scheduler): the pod-level shaper and
        # the per-drain (tick, shard, rung, depth[, seconds]) logs
        self.scheduler = None
        self.rung_log: list = []
        self.drain_log: list = []
        # the pod-of-pods seams: the autoscaler (built by attach_scheduler
        # with autoscale_enable), parked shards (engine wiped, membership
        # kept), the streams borrowed away this tick
        self.autoscaler = None
        self._parked: set = set()
        self.scale_events: list = []
        self.steal_drops = 0
        self._stolen_this_tick: set = set()
        # queued ticks a park would strand, shed through the shaper's
        # counters (_park_shard)
        self.park_sheds = 0
        # the pod-level shared world (attach_world_map)
        self.world = None

    # -- warm-up ------------------------------------------------------------

    def precompile(self, formats) -> None:
        """Warm every shard's engines (the fleet tick for every padding
        bucket, the mapper's tick when ``map_enable``, the loop engine when
        ``loop_enable``, the row snapshot and restore), capture each
        engine's cold-reset template, and capture the fresh-lane rows that
        scrub a lane whose new tenant has no snapshot yet.  After this a
        whole kill -> evacuate -> re-admit cycle builds nothing."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import is_carried

        for sh in self.shards:
            sh._ensure_byte_ingest()
            sh.fleet_ingest.precompile(formats)
            # the shard-kill wipe template, captured before traffic
            sh.fleet_ingest.capture_cold_template()
            if getattr(self.params, "map_enable", False) and sh.mapper is None:
                sh.attach_mapper()
            if getattr(self.params, "loop_enable", False) and sh.loop is None:
                # the back-end rides each shard's mapper
                sh.attach_loop_closure()
            sh._warm_quarantine_path()
        if self._fresh_snap is None:
            # the engines are fresh here (precompile before traffic), so
            # lane 0's rows ARE the fresh-lane template
            sh0 = self.shards[0]
            self._fresh_snap = {"ingest": sh0.fleet_ingest.snapshot_stream(0)}
            if sh0.mapper is not None and not is_carried(sh0.mapper):
                # carried maps ride the ingest snapshot (v3)
                self._fresh_snap["map"] = sh0.mapper.snapshot_stream(0)
            if sh0.loop is not None:
                self._fresh_snap["loop"] = sh0.loop.snapshot_stream(0)

    # -- the shared world ---------------------------------------------------

    def attach_world_map(self, world=None) -> "object":
        """Attach ONE pod-level shared world (built from params when not
        given): every shard's finalized submaps fuse into the same
        accumulation on the card — order-free, the fusion is an int32 sum —
        and a due tile publication rides the first double-buffered shard's
        idle half each pod drain (:meth:`drain_scheduled`).  Shards with a
        loop engine feed it through the engine's ``on_install`` tap (the
        lane resolved to its global stream at install time); shards without
        one contribute row snapshots at the ``world_merge_revs`` cadence
        after their drain.  Needs :meth:`precompile` first (the shard
        mappers must exist)."""
        if self.shards[0].mapper is None:
            raise RuntimeError(
                "attach_world_map needs the shard mappers: run "
                "precompile(formats) with map_enable first"
            )
        if world is None:
            from rplidar_ros2_driver_tpu_torch.mapping.worldmap import (
                WorldMap,
                world_config_from_params,
            )

            world = WorldMap(world_config_from_params(self.params, self.shards[0].mapper.cfg),
                             device=self.meshes[0].device)
        world.precompile()
        self.world = world
        for s, sh in enumerate(self.shards):
            if sh.loop is not None:
                sh.loop.on_install = self._make_world_tap(s)
        return world

    def _make_world_tap(self, s: int):
        """A shard-bound ``on_install`` tap: resolves the installing LANE
        to its current global stream when called (steals and scale events
        move placements) and fuses the library's plane into the world."""

        def tap(lane: int, plane, anchor) -> None:
            if self.world is None:
                return
            tbl = self.topology.lane_streams(s)
            stream = tbl[lane] if lane < len(tbl) else None
            self.world.ingest_submap(lane if stream is None else stream, plane, anchor)

        return tap

    def _world_merge_shard(self, s: int, eff: list) -> None:
        """Shard ``s``'s merge without a loop engine, after its drain:
        streams whose revolution count crossed the merge cadence
        contribute a row snapshot quantized through the one finalization
        path (mapping/submap.quantize_submap_plane)."""
        sh = self.shards[s]
        if self.world is None or sh.loop is not None or sh.mapper is None:
            return
        from rplidar_ros2_driver_tpu_torch.mapping.submap import quantize_submap_plane

        for lane, stream in enumerate(eff):
            if stream is None:
                continue
            est = sh.last_poses[lane]
            if est is None:
                continue
            rev = int(est.revision)
            if self.world.merge_due(stream, rev):
                snap = sh.mapper.snapshot_stream(lane)
                plane = quantize_submap_plane(snap["log_odds"], sh.mapper.cfg)
                self.world.ingest_submap(stream, plane, snap["pose"])
                self.world.note_merged(stream, rev)

    def world_status(self) -> Optional[dict]:
        """The /diagnostics "World Map" payload (None without a world)."""
        return None if self.world is None else self.world.status()

    # -- chaos seam ---------------------------------------------------------

    def attach_shard_chaos(self, schedule) -> None:
        """Attach a deterministic shard-loss schedule
        (driver/chaos.ShardChaosSchedule): shards it marks down are forced
        LOST at the tick boundary, and — unless a caller probe is wired —
        re-admission probes answer from the same schedule, so the whole
        kill -> evacuate -> re-admit cycle is a pure function of (seed,
        tick)."""
        self.chaos = schedule
        if not self._chaos_probe_wired:
            for s, hs in enumerate(self.shard_health):
                if hs.probe is None:
                    hs.probe = lambda s=s: not self.chaos.down(s, self.tick_no)
            self._chaos_probe_wired = True

    # -- the pod tick -------------------------------------------------------

    def submit_bytes(self, items) -> list:
        """One pod tick from raw frame bytes (``items[i]`` is stream i's
        ``(ans_type, [(payload, ts), ...])`` or None).  Routes each stream's
        bytes to its hosting shard, runs every hosting shard's one-dispatch
        tick and returns one Optional[FilterOutput] per GLOBAL stream (None:
        idle, no completed revolution, or unhosted).

        The tick boundary handles faults in order: chaos kills (LOST +
        evacuation), re-admission polls (backoff + probe -> rebalance), then
        the routed dispatches (a raised dispatch is a heartbeat failure: the
        shard is LOST and evacuated, its victims lose this tick).  Periodic
        snapshots refresh after the dispatches, so a snapshot never holds a
        half-applied tick."""
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardState

        if self._parked:
            raise RuntimeError(
                f"pod is autoscaled down (parked shards: {sorted(self._parked)}) — the "
                "per-tick seam has no scale-up path; use offer_bytes/drain_scheduled"
            )
        if len(items) != self.streams:
            raise ValueError(f"expected {self.streams} per-stream items, got {len(items)}")
        t = self.tick_no
        t0 = time.perf_counter()
        self._tick_faults()
        # routing is FROZEN before the loop: a heartbeat failure mid-loop
        # evacuates its victims, but their bytes for THIS tick died with
        # the dispatch that consumed them — delivering them again to the
        # new shard would apply the tick twice
        outs: list = [None] * self.streams
        routing = []
        for s, hs in enumerate(self.shard_health):
            if hs.hosting:
                routing.append((s, hs, self.topology.lane_streams(s),
                                self.topology.lane_items(s, items)))
        for s, hs, lane_streams, lane_items in routing:
            if not hs.hosting:
                continue  # lost mid-loop (cascading failure)
            if not any(st is not None for st in lane_streams):
                tr = hs.observe(False, 0)
                if tr is not None and tr[1] is ShardState.LOST:
                    self._on_lost(s, hs.last_reason)
                continue  # empty shard: nothing to dispatch
            offered = any(it for it in lane_items)
            try:
                shard_outs = self.shards[s].submit_bytes(lane_items)
            except Exception as e:  # noqa: BLE001 - the heartbeat boundary
                logger.exception("shard %d dispatch failed", s)
                self._lose_shard(s, f"heartbeat: {type(e).__name__}: {e}")
                # the victims lose THIS tick's bytes too (consumed by the
                # dead dispatch): excluded from the replay plan
                for stream in lane_streams:
                    if stream is not None and items[stream]:
                        self._excluded[stream].add(t)
                continue
            completed = 0
            for lane, stream in enumerate(lane_streams):
                if stream is None:
                    continue
                outs[stream] = shard_outs[lane]
                self.last_poses[stream] = self.shards[s].last_poses[lane]
                if shard_outs[lane] is not None:
                    completed += 1
                if items[stream]:
                    self._since_snap[stream].append(t)
            tr = hs.observe(offered, completed)
            if tr is not None and tr[1] is ShardState.LOST:
                # FSM-driven loss (starvation walked the ladder, or a
                # READMITTING relapse): the same wipe + evacuate as a hard
                # kill — the device answered but completed nothing, so its
                # state is not trusted
                self._on_lost(s, hs.last_reason)
        # unhosted streams (double loss without capacity): their bytes never
        # reach a device — excluded, output masked
        for stream in self.topology.unhosted():
            if items[stream]:
                self._excluded[stream].add(t)
        if self.snapshot_ticks > 0 and (t + 1) % self.snapshot_ticks == 0:
            self._refresh_snapshots(t)  # the state now includes tick t
        if self._first_tick_pending and self.last_evacuation is not None:
            self.last_evacuation["first_tick_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            self._first_tick_pending = False
        self.tick_no += 1
        return outs

    def _tick_faults(self) -> None:
        """The tick-boundary fault handling, in order: chaos kills — the
        tick's WHOLE down set is forced LOST before any evacuation runs, so
        no victim lands on a shard the schedule also kills this tick — then
        re-admission polls (engines wiped at loss, rebalance before this
        tick's bytes flow)."""
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardState

        t = self.tick_no
        if self.chaos is not None:
            downed = [s for s, hs in enumerate(self.shard_health)
                      if hs.state is not ShardState.LOST and self.chaos.down(s, t)]
            for s in downed:
                self.shard_health[s].force_lost("chaos: shard killed")
            for s in downed:
                self._on_lost(s, "chaos: shard killed")
        for s, hs in enumerate(self.shard_health):
            if hs.poll_readmit() is not None:
                self._readmit_shard(s)

    # -- the scheduled seam -------------------------------------------------

    def attach_scheduler(self, shaper=None) -> "object":
        """Attach a pod-level TrafficShaper (built from this pod's
        ``sched_*``/``admission_*`` params when not given): per-STREAM
        bounded admission queues (they follow a stream across migrations),
        one rung ladder PER SHARD, and the byte-rate EWMA that weights
        placement, so evacuation and re-admission land hot streams on cold
        shards.  With ``autoscale_enable`` also the PodAutoscaler.  Must run
        BEFORE :meth:`precompile` so every rung is warmed on every shard's
        engine (the engines refuse late extensions)."""
        from rplidar_ros2_driver_tpu_torch.parallel.scheduler import (
            PodAutoscaler,
            SchedulerConfig,
            TrafficShaper,
        )

        if shaper is None:
            shaper = TrafficShaper(self.streams, SchedulerConfig.from_params(self.params),
                                   shards=len(self.shards))
        if shaper.streams != self.streams or len(shaper.ladders) != len(self.shards):
            raise ValueError(
                f"shaper geometry ({shaper.streams} streams, {len(shaper.ladders)} ladders) "
                f"does not match the pod ({self.streams} streams, {len(self.shards)} shards)"
            )
        if ((shaper.cfg.steal_threshold_ticks > 0 or shaper.cfg.autoscale_enable)
                and getattr(self.params, "loop_enable", False)):
            # steal and scale moves carry ingest and map rows; loop rows do
            # not migrate, so a borrowed lane would run the back-end over a
            # stranger's history
            raise ValueError(
                "work stealing / autoscale do not support the loop-closure "
                "back-end (loop rows do not migrate)"
            )
        for sh in self.shards:
            sh._ensure_byte_ingest()
            sh.fleet_ingest.ensure_rungs(shaper.cfg.rungs)
        self.scheduler = shaper
        self.rung_log = []
        self.drain_log = []
        if shaper.cfg.autoscale_enable:
            self.autoscaler = PodAutoscaler(shaper.cfg, self.topology.lanes)
        return shaper

    def _refresh_weights(self) -> None:
        """The shaper's byte-rate EWMAs as placement weights, ``1 +
        rate/mean``: idle streams keep the stream-count rule, one hot
        stream outweighs several cold ones."""
        rates = self.scheduler.rates.rates()
        live = [r for r in rates if r > 0]
        if not live:
            return
        mean = sum(live) / len(live)
        for i, r in enumerate(rates):
            self.topology.set_weight(i, 1.0 + r / mean)

    def offer_bytes(self, items) -> None:
        """Admit one wall tick of pod arrivals (the :meth:`submit_bytes`
        layout; an entry may be a LIST of data ticks — a reconnect storm).
        Admission sheds and the weight refresh happen here; nothing
        dispatches until :meth:`drain_scheduled`."""
        if self.scheduler is None:
            raise RuntimeError("attach_scheduler() first")
        if len(items) != self.streams:
            raise ValueError(f"expected {self.streams} per-stream items, got {len(items)}")
        self.scheduler.offer_tick(items)
        self._refresh_weights()

    def drain_scheduled(self) -> list:
        """One scheduled pod drain: the tick-boundary faults
        (:meth:`_tick_faults`), the autoscaler's observation, the steal
        plan, then every hosting shard drains its streams' queued backlog
        at the rung ITS ladder picks, the drain timed into the ladder's
        latency model.  A raised drain is the heartbeat failure: the shard
        is LOST and evacuated; the popped ticks died with it, the victims'
        queues survive.  A borrowed stream's row is copied LIVE onto the
        taker's idle lane before the taker's drain and back after it.
        Returns per-GLOBAL-stream lists of FilterOutputs in tick order."""
        if self.scheduler is None:
            raise RuntimeError("attach_scheduler() first")
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardState
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import is_carried

        t = self.tick_no
        t0 = time.perf_counter()
        self._tick_faults()
        self._tick_autoscale()
        outs: list = [[] for _ in range(self.streams)]
        snap_due = self.snapshot_ticks > 0 and (t + 1) % self.snapshot_ticks == 0
        steals = self._plan_steals()
        stolen_away = {stream for plans in steals.values() for stream, _src in plans}
        self._stolen_this_tick = stolen_away
        # ONE due tile publication a pod drain: the first double-buffered
        # shard's idle half claims it, else the epilogue runs it
        world_box = {"pub": self.world.overlap_hook() if self.world is not None else None}
        for s, hs in enumerate(self.shard_health):
            if not hs.hosting or s in self._parked:
                continue
            sh = self.shards[s]
            eng = sh.fleet_ingest
            if eng is not None and eng.warmup_costs:
                # one pod model: each engine's warm-up timings seed the
                # keys still absent
                self.scheduler.model.seed_many(eng.warmup_costs)
                eng.warmup_costs = {}
            lane_streams = self.topology.lane_streams(s)
            # a donor's stolen streams are masked out of its own plan: its
            # lanes idle through this drain (rows carried through)
            plan_ids = ([None if st in stolen_away else st for st in lane_streams]
                        if stolen_away else lane_streams)
            borrows = self._stage_borrows(s, steals.get(s, []))
            ticks, rung = self.scheduler.drain_plan(s, plan_ids,
                                                     extra_streams=[b[0] for b in borrows])
            if not ticks:
                # nothing queued: no pose is current this tick (stolen
                # streams are the taker's to publish)
                for stream in lane_streams:
                    if stream is not None and stream not in stolen_away:
                        self.last_poses[stream] = None
                # the FSM still observes the empty drain
                tr = hs.observe(False, 0)
                if tr is not None and tr[1] is ShardState.LOST:
                    self._on_lost(s, hs.last_reason)
                continue
            bucket = self.scheduler.bucket_plan(s)
            if bucket is not None:
                eng.set_active_bucket(bucket)
            # this shard's lanes plus the rows borrowed onto its idle ones
            eff = list(lane_streams)
            for stream, _src, _sl, lane in borrows:
                eff[lane] = stream
            borrow_lanes = {lane for *_x, lane in borrows}
            lane_ticks = [[None if st is None else tick[st] for st in eff] for tick in ticks]
            offered = any(any(it for it in lt) for lt in lane_ticks)
            overlap = None
            if eng is not None and eng.double_buffer:
                # due snapshot pulls ride the idle half (a non-carried
                # mapper updates after the engine drain returns, so its
                # rows are not final yet: those shards pull in the
                # epilogue)
                do_snap = snap_due and (sh.mapper is None or is_carried(sh.mapper))
                world_pub = world_box["pub"]
                if do_snap or world_pub is not None:
                    world_box["pub"] = None

                    def overlap(t=t, s=s, do_snap=do_snap, wp=world_pub):
                        if do_snap:
                            self._overlap_snapshots(t, s)
                        if wp is not None:
                            wp()

            x0 = time.perf_counter()
            try:
                shard_outs = sh.submit_bytes_backlog(lane_ticks, rung=rung, overlap_work=overlap)
            except Exception as e:  # noqa: BLE001 - the heartbeat boundary
                logger.exception("shard %d drain failed", s)
                self._lose_shard(s, f"heartbeat: {type(e).__name__}: {e}")
                # the popped ticks died with the dispatch (the pre-loss
                # lane table; a stream stolen away is the taker's)
                for stream in lane_streams:
                    if stream is not None and stream not in stolen_away:
                        self._excluded[stream].add(t)
                for stream, _src, _sl, _bl in borrows:
                    # the return never ran: the donor holds the pre-drain
                    # row, only the popped wall tick is lost
                    self._excluded[stream].add(t)
                continue
            dt = time.perf_counter() - x0
            self.scheduler.note_drain(s, len(ticks), dt, rung=rung,
                                      bucket=None if eng is None else eng.slicing_bucket)
            self.rung_log.append((t, s, rung, len(ticks)))
            self.drain_log.append((t, s, rung, len(ticks), dt))
            completed = 0
            for lane, stream in enumerate(eff):
                if stream is None:
                    continue
                if stream in stolen_away and lane not in borrow_lanes:
                    continue  # drained by the taker this tick
                outs[stream].extend(shard_outs[lane])
                self.last_poses[stream] = sh.last_poses[lane]
                completed += len(shard_outs[lane])
                if any(tick[stream] for tick in ticks):
                    # one wall tick of un-snapshotted history, however
                    # deep the drained backlog
                    self._since_snap[stream].append(t)
            self._world_merge_shard(s, eff)
            self._return_borrows(s, borrows)
            tr = hs.observe(offered, completed)
            if tr is not None and tr[1] is ShardState.LOST:
                self._on_lost(s, hs.last_reason)
        self._stolen_this_tick = set()
        if self.world is not None and world_box["pub"] is not None:
            world_box["pub"]()
        # unhosted streams' queues keep building toward the admission
        # bound: nothing to exclude, the data is still queued
        if snap_due:
            self._refresh_snapshots(t)
        if self._first_tick_pending and self.last_evacuation is not None:
            self.last_evacuation["first_tick_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            self._first_tick_pending = False
        self.tick_no += 1
        return outs

    # -- work stealing and autoscale ------------------------------------------

    def _plan_steals(self) -> dict:
        """This wall tick's steal plan ({taker: [(stream, donor), ...]})
        from the shaper, fed the live membership: hosting, unparked shards
        and their free-lane counts."""
        sched = self.scheduler
        if sched is None or sched.cfg.steal_threshold_ticks <= 0:
            return {}
        hosted: dict = {}
        free: dict = {}
        for s, hs in enumerate(self.shard_health):
            if not hs.hosting or s in self._parked:
                continue
            tbl = self.topology.lane_streams(s)
            hosted[s] = [st for st in tbl if st is not None]
            free[s] = sum(1 for st in tbl if st is None)
        if len(hosted) < 2:
            return {}
        return sched.plan_steals(hosted, free)

    def _stage_borrows(self, s: int, plans: list) -> list:
        """Copy each planned donor row LIVE onto one of taker ``s``'s idle
        lanes before its drain.  Best effort: a donor that died or parked,
        a stream moved since planning, or no idle lane left drops the
        borrow (its queue was not popped; it drains at home next tick).
        Returns ``[(stream, donor, donor_lane, borrow_lane), ...]``."""
        if not plans:
            return []
        t = self.tick_no
        idle = [lane for lane, st in enumerate(self.topology.lane_streams(s)) if st is None]
        out = []
        for stream, src in plans:
            got = self.topology.placement(stream)
            if (not idle or src in self._parked or not self.shard_health[src].hosting
                    or got is None or got[0] != src):
                self.steal_drops += 1
                self._stolen_this_tick.discard(stream)
                continue
            lane = idle.pop(0)
            self._move_row_live(stream, src, got[1], s, lane)
            out.append((stream, src, got[1], lane))
            self.events.append((t, "stolen", stream, src, s, lane))
        return out

    def _return_borrows(self, s: int, borrows: list) -> None:
        """Copy each borrowed row home after the taker's drain (placement
        never moved, so the steal ends when the row lands)."""
        for stream, src, src_lane, lane in borrows:
            self._move_row_live(stream, s, lane, src, src_lane)

    def _move_row_live(self, stream: int, src: int, src_lane: int, dst: int,
                       dst_lane: int) -> None:
        """Move a row between two HEALTHY engines with its decode carries
        (``restore_decode=True``): nothing resets and nothing enters the
        replay plan, so steals and graceful scale moves leave the outputs
        unchanged.  The map row travels as ``carried_map_row`` of the
        ingest snapshot on the carried route, as the mapper's own
        ``snapshot_stream`` otherwise."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import carried_map_row, is_carried

        snap = self.shards[src].fleet_ingest.snapshot_stream(src_lane)
        sh = self.shards[dst]
        if not sh.fleet_ingest.restore_stream(dst_lane, snap, restore_decode=True):
            raise RuntimeError(
                f"stream {stream}: live row rejected by shard {dst} lane {dst_lane} "
                "(schema/geometry drift)"
            )
        if sh.mapper is None:
            return
        if is_carried(sh.mapper):
            ok = sh.mapper.restore_stream(dst_lane, carried_map_row(snap))
        else:
            ok = sh.mapper.restore_stream(dst_lane,
                                          self.shards[src].mapper.snapshot_stream(src_lane))
        if not ok:
            raise RuntimeError(
                f"stream {stream}: live map row rejected by shard {dst} lane {dst_lane} "
                "(schema/geometry drift)"
            )

    def _tick_autoscale(self) -> None:
        """One autoscaler observation at the tick boundary; a decision
        parks (down) or unparks (up) one shard.  Scale-down needs the
        survivors' lanes to cover the LIVE streams (byte rate over the
        floor) and the shard floor; scale-up needs a parked shard."""
        if self.autoscaler is None:
            return
        active = [s for s, hs in enumerate(self.shard_health)
                  if hs.hosting and s not in self._parked]
        if not active:
            return
        cfg = self.autoscaler.cfg
        rates = self.scheduler.rates.rates()
        live = self.autoscaler.live_streams(rates)
        can_down = (len(active) > cfg.autoscale_min_shards
                    and (len(active) - 1) * self.topology.lanes >= live)
        d = self.autoscaler.note_tick(rates, len(active), can_down=can_down,
                                      can_up=bool(self._parked))
        if d == "down":
            self._park_shard(min(active, key=lambda s: (self.topology.shard_load(s), s)))
        elif d == "up":
            self._unpark_shard(min(self._parked))

    def _park_shard(self, s: int) -> None:
        """Autoscale DOWN: drain shard ``s`` out of the pod.  Every hosted
        stream's row moves LIVE onto siblings' idle lanes (the placement is
        the failover evacuate relabel); a stream the survivors cannot host
        has its queued backlog shed through the shaper's counters and its
        row snapshotted, for the scale-up rebalance to restore.  Then the
        engine is wiped in place (``cold_reset``) and the mapper reset."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import is_carried

        t = self.tick_no
        lane_of = {stream: self.topology.placement(stream)[1]
                   for stream in self.topology.streams_on(s)}
        avoid = sorted({x for x, hs in enumerate(self.shard_health)
                        if not hs.hosting and x != s} | (self._parked - {s}))
        plan = self.topology.evacuate(s, avoid=avoid)
        if len(plan) != len(lane_of):
            moved = {stream for stream, _dst, _lane in plan}
            sh = self.shards[s]
            for stream in sorted(lane_of):
                if stream in moved:
                    continue
                snap = {"ingest": sh.fleet_ingest.snapshot_stream(lane_of[stream])}
                if sh.mapper is not None and not is_carried(sh.mapper):
                    snap["map"] = sh.mapper.snapshot_stream(lane_of[stream])
                self._snap[stream] = (t, snap)
                shed = 0 if self.scheduler is None else self.scheduler.shed_stream(stream)
                self.park_sheds += shed
                self.events.append((t, "park_shed", stream, s, shed))
        for stream, dst, lane in plan:
            self._move_row_live(stream, s, lane_of[stream], dst, lane)
            self.migrations += 1
            self.shard_migrations_in[dst] += 1
            self.shard_last_migration_tick[dst] = t
            self.last_migration_tick = t
            self.events.append((t, "scale_down_migrated", stream, s, dst, lane))
        self._parked.add(s)
        self.streams_lost_unhosted = len(self.topology.unhosted())
        self.scale_events.append((t, "down", s))
        self.events.append((t, "scale_down", s))
        sh = self.shards[s]
        if sh.fleet_ingest is not None:
            sh.fleet_ingest.cold_reset()
        if sh.mapper is not None:
            sh.mapper.reset()
        logger.info("shard %d parked (autoscale down), %d streams moved live", s, len(plan))

    def _unpark_shard(self, s: int) -> None:
        """Autoscale UP: re-admit parked shard ``s`` (wiped at park time,
        every step still warm) through ``topology.rebalance_into``; movers
        travel LIVE, and a stream stranded unhosted restores from its stored
        snapshot with the failover reset/replay bookkeeping."""
        t = self.tick_no
        self._parked.discard(s)
        self.scale_events.append((t, "up", s))
        self.events.append((t, "scale_up", s))
        moves = self.topology.rebalance_into(s)
        for stream, src, src_lane, dst, lane in moves:
            if src < 0:
                entry = self._snap.get(stream)
                self._restore_into(stream, dst, lane, entry[1] if entry else None)
                self._resets[stream].add(t)
            else:
                self._move_row_live(stream, src, src_lane, dst, lane)
            self.migrations += 1
            self.shard_migrations_in[dst] += 1
            self.shard_last_migration_tick[dst] = t
            self.last_migration_tick = t
            self.events.append((t, "scale_up_migrated", stream, src, dst, lane))
        self.streams_lost_unhosted = len(self.topology.unhosted())
        logger.info("shard %d unparked (autoscale up), %d streams moved", s, len(moves))

    # graftlint: read-path
    def scheduler_status(self) -> Optional[dict]:
        """The /diagnostics scheduler payload (None without a shaper): the
        shaper's status with the rung, (rung, bucket) and staging-overlap
        counters summed over the pod's engines, and the placement
        weights."""
        if self.scheduler is None:
            return None
        status = self.scheduler.status()
        rung_d: dict = {}
        rb: dict = {}
        overlap_hits = 0
        for sh in self.shards:
            if sh.fleet_ingest is None:
                continue
            for r, n in sh.fleet_ingest.rung_dispatches.items():
                rung_d[r] = rung_d.get(r, 0) + n
            for key, n in sh.fleet_ingest.rung_bucket_dispatches.items():
                rb[key] = rb.get(key, 0) + n
            overlap_hits += sh.fleet_ingest.staging_overlap_hits
        status["rung_dispatches"] = rung_d
        status["rung_bucket_dispatches"] = {f"T{r}xM{b}": n for (r, b), n in sorted(rb.items())}
        status["staging_overlap_hits"] = overlap_hits
        status["weights"] = [round(self.topology.weight_of(i), 3) for i in range(self.streams)]
        return status

    # -- snapshots ----------------------------------------------------------

    def _live_snapshot(self, s: int, lane: int) -> dict:
        """One lane's row snapshot from shard ``s``'s live engines (row
        gather + declared row fetch — O(1/lanes) of the shard state).  On
        the carried route the map rows ride the ingest snapshot (v3), so no
        second pull of the same planes."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import is_carried

        sh = self.shards[s]
        snap = {"ingest": sh.fleet_ingest.snapshot_stream(lane)}
        if sh.mapper is not None and not is_carried(sh.mapper):
            snap["map"] = sh.mapper.snapshot_stream(lane)
        return snap

    def _overlap_snapshots(self, t: int, s: int) -> None:
        """Snapshot pulls on the idle half of shard ``s``'s double buffer:
        the row gathers are queued after the drain's steps on the same
        stream, so they hold the post-drain rows, as an epilogue pull
        would.  :meth:`_refresh_snapshots` recognises streams pulled here
        (same stored tick) and only clears their bookkeeping.  A stream
        borrowed away this tick is left to the epilogue: its home row is
        behind its borrowed copy until it returns."""
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardState

        if self.shard_health[s].state is not ShardState.UP:
            return
        for lane, stream in enumerate(self.topology.lane_streams(s)):
            if stream is None or stream in self._stolen_this_tick:
                continue
            self._snap[stream] = (t, self._live_snapshot(s, lane))

    def _refresh_snapshots(self, t: int) -> None:
        """Refresh the snapshot store for every hosted stream on an UP
        shard; the stored tick says how much history the snapshot holds
        (ticks <= t).  SUSPECT and READMITTING shards are skipped: their
        state is what the FSM stopped trusting, and restoring from it later
        would break the replay plan (which excludes every tick since the
        last TRUSTED snapshot).  A stream already pulled at tick t on a
        drain's idle half only has its bookkeeping cleared."""
        from rplidar_ros2_driver_tpu_torch.driver.health import ShardState

        for stream in range(self.streams):
            got = self.topology.placement(stream)
            if got is None or self.shard_health[got[0]].state is not ShardState.UP:
                continue
            if self._snap.get(stream, (None, None))[0] == t:
                self._since_snap[stream] = []
                continue
            self._snap[stream] = (t, self._live_snapshot(*got))
            self._since_snap[stream] = []

    def _restore_into(self, stream: int, dst: int, lane: int, snap: Optional[dict]) -> None:
        """Install ``snap`` (or the fresh-lane rows) into the destination
        lane BEFORE bytes flow: filter window and map restored, decode
        carries reset (the stream re-enters the byte stream at an arbitrary
        capsule boundary).  Always restores — a reused lane may hold a
        previous tenant's rows."""
        use = snap if snap is not None else self._fresh_snap
        if use is None:
            raise RuntimeError(
                "ElasticFleetService.precompile() must run before migrations "
                "(no fresh-lane template captured)"
            )
        sh = self.shards[dst]
        if not sh.fleet_ingest.restore_stream(lane, use["ingest"]):
            raise RuntimeError(
                f"stream {stream}: ingest snapshot rejected by shard {dst} lane {lane} "
                "(schema/geometry drift)"
            )
        if sh.mapper is None:
            return
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import carried_map_row, is_carried

        if is_carried(sh.mapper):
            # the map row travels INSIDE the ingest snapshot (v3
            # ingest.map_* keys); the rejoin-style restore above touches
            # only the filter rows, so the carried row is installed here
            ok = sh.mapper.restore_stream(lane, carried_map_row(use["ingest"]))
        else:
            ok = "map" in use and sh.mapper.restore_stream(lane, use["map"])
        if not ok:
            raise RuntimeError(
                f"stream {stream}: map snapshot rejected by shard {dst} lane {lane} "
                "(schema/geometry drift)"
            )

    # -- failure handling ---------------------------------------------------

    def _lose_shard(self, s: int, reason: str) -> None:
        """Shard ``s`` died hard (a raised dispatch): force its FSM LOST,
        then wipe and evacuate."""
        self.shard_health[s].force_lost(reason)
        self._on_lost(s, reason)

    def _on_lost(self, s: int, reason: str) -> None:
        """The loss handler of every path to LOST (hard kills and FSM
        walks): wipe the shard's engines in place (stale state never
        survives into a re-admission) and evacuate every victim from its
        LAST snapshot into surviving shards' idle lanes."""
        self.events.append((self.tick_no, "lost", s, reason))
        sh = self.shards[s]
        if sh.fleet_ingest is not None:
            sh.fleet_ingest.cold_reset()
        if sh.mapper is not None:
            sh.mapper.reset()
        self._evacuate_shard(s)

    def _evacuate_shard(self, s: int) -> None:
        t = self.tick_no
        t0 = time.perf_counter()
        # victims land only on shards that can host them: never on an
        # earlier casualty's wiped lanes, nor on a parked shard's
        dead = [x for x, hs in enumerate(self.shard_health)
                if (not hs.hosting or x in self._parked) and x != s]
        victims = self.topology.streams_on(s)
        plan = self.topology.evacuate(s, avoid=dead)
        # the ticks the dead shard absorbed after the last snapshot are
        # lost for EVERY victim, one left unhosted included (its later
        # re-admission restores from that same snapshot)
        for stream in victims:
            self._excluded[stream].update(self._since_snap[stream])
            self._since_snap[stream] = []
        # the dead shard's device state is gone: the store is the source
        snaps = {stream: self._snap.get(stream) for stream, _d, _l in plan}
        t1 = time.perf_counter()
        for stream, dst, lane in plan:
            entry = snaps[stream]
            self._restore_into(stream, dst, lane, entry[1] if entry else None)
            self._resets[stream].add(t)
            self.migrations += 1
            self.shard_migrations_in[dst] += 1
            self.shard_last_migration_tick[dst] = t
            self.events.append((t, "evacuated", stream, s, dst, lane))
        t2 = time.perf_counter()
        unhosted = self.topology.unhosted()
        if unhosted:
            self.streams_lost_unhosted = len(unhosted)
            logger.error("shard %d loss left streams %s unhosted (no idle lanes — double "
                         "loss?); they stay masked until a shard re-admits", s, unhosted)
        self.evacuations += 1
        self.shard_evacuations[s] += 1
        self.last_migration_tick = t
        self.last_evacuation = {
            "tick": t,
            "shard": s,
            "streams": [stream for stream, _d, _l in plan],
            "snapshot_pull_ms": round((t1 - t0) * 1e3, 3),
            "restore_scatter_ms": round((t2 - t1) * 1e3, 3),
            "first_tick_ms": None,
        }
        self.evacuation_log.append(self.last_evacuation)
        self._first_tick_pending = True
        logger.warning("shard %d evacuated: %d streams restored onto survivors "
                       "(pull %.1f ms, restore %.1f ms)",
                       s, len(plan), (t1 - t0) * 1e3, (t2 - t1) * 1e3)

    def _readmit_shard(self, s: int) -> None:
        """Shard ``s`` passed its backoff + probe gate: its engines were
        wiped at loss, so streams rebalance back onto it — each mover's
        state travels as a FRESH live snapshot from its current shard (no
        lost ticks; the partial revolution in flight is dropped by the
        decode reset, recorded in the replay plan)."""
        t = self.tick_no
        self.readmits += 1
        self.events.append((t, "readmitting", s))
        for stream, src, src_lane, dst, lane in self.topology.rebalance_into(s):
            if src < 0:
                # was unhosted: its last stored snapshot (the ticks after
                # it were excluded when it went unhosted)
                entry = self._snap.get(stream)
                snap = entry[1] if entry else None
            else:
                snap = self._live_snapshot(src, src_lane)
                # the live snapshot holds everything up to tick t-1
                self._snap[stream] = (t - 1, snap)
                self._since_snap[stream] = []
            self._restore_into(stream, dst, lane, snap)
            self._resets[stream].add(t)
            self.migrations += 1
            self.shard_migrations_in[dst] += 1
            self.shard_last_migration_tick[dst] = t
            self.last_migration_tick = t
            self.events.append((t, "migrated", stream, src, dst, lane))
        self.streams_lost_unhosted = len(self.topology.unhosted())

    # -- observability ------------------------------------------------------

    def replay_plan(self) -> list[dict]:
        """Per-stream host-golden replay plan: feed every tick's bytes
        EXCEPT the ``excluded`` ones to an independent decoder + assembler +
        chain (+ host mapper), resetting decoder and assembler at each
        ``resets`` tick — the filter window and map carry through, like the
        restored rows.  That replay equals this pod's outputs for the
        stream, final map included."""
        return [{"resets": sorted(self._resets[i]), "excluded": sorted(self._excluded[i])}
                for i in range(self.streams)]

    def shard_status(self) -> list[dict]:
        """Per-shard dicts for /diagnostics (node/diagnostics.py renders
        them under the ``shard_topology`` surface)."""
        out = []
        for s, hs in enumerate(self.shard_health):
            d = hs.status()
            d["host"] = self.topology.host_of(s)
            d["parked"] = s in self._parked
            d["streams"] = self.topology.streams_on(s)
            d["evacuations"] = self.shard_evacuations[s]
            d["migrations_in"] = self.shard_migrations_in[s]
            d["last_migration_tick"] = self.shard_last_migration_tick[s]
            out.append(d)
        return out

    def failover_status(self) -> dict:
        """Pod-level failover counters + per-shard states — the
        /diagnostics topology payload."""
        return {
            "shards": self.shard_status(),
            "evacuations": self.evacuations,
            "migrations": self.migrations,
            "readmits": self.readmits,
            "last_migration_tick": self.last_migration_tick,
            "unhosted": self.topology.unhosted(),
        }

    def pod_status(self) -> dict:
        """The /diagnostics "Pod" payload: per-host shard states (a parked
        shard reports PARKED — its FSM still says UP, but its engine is
        wiped), the steal and scale counters and the autoscaler's state."""
        per_host = [
            {"host": h, "shards": [
                {"shard": s,
                 "state": "PARKED" if s in self._parked else self.shard_health[s].state.name,
                 "streams": len(self.topology.streams_on(s))}
                for s in self.topology.shards_on_host(h)]}
            for h in range(self.topology.hosts)
        ]
        sched, auto = self.scheduler, self.autoscaler
        return {
            "hosts": self.topology.hosts,
            "per_host": per_host,
            "parked": sorted(self._parked),
            "steals": 0 if sched is None else sched.steals,
            "steal_ticks": 0 if sched is None else sched.steal_ticks,
            "steal_drops": self.steal_drops,
            "park_sheds": self.park_sheds,
            "scale_downs": 0 if auto is None else auto.scale_downs,
            "scale_ups": 0 if auto is None else auto.scale_ups,
            "autoscaler": None if auto is None else auto.status(),
        }
