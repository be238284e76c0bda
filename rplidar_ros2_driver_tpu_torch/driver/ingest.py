"""FusedIngest / FleetFusedIngest — the device ingest engines
(``ingest_backend=fused`` / ``fleet_ingest_backend=fused``).

The PyTorch counterpart of the JAX package's ``driver/ingest.py``.
:class:`FusedIngest` is the producer twin of driver/decode.BatchScanDecoder
(same ``on_measurement_batch`` interface, so driver/real.RealLidarDriver
streams into it from its pump thread): each frame run is staged into a
reused host buffer (pinned when the engine runs on the card), uploaded
without blocking, and run through ops/ingest.fused_ingest_step — unpack,
revolution segmentation, de-skew and the filter step on the device — and
the results start their copy back to pinned host memory at once, with a
CUDA event marking them landed.  The consumer side
(:meth:`FusedIngest.wait_and_grab_outputs`,
:meth:`FusedIngest.collect_pipelined`) parses a dispatched batch's landed
results into the completed revolutions' FilterOutputs with their
back-dated timestamps.  :class:`FleetFusedIngest` does the same for N
streams per tick (ops/ingest.fleet_fused_ingest_step), and drains a
backlog of ticks T at a time through the super-step.

The host path (decoder + assembler + chain) stays the golden reference;
the engines are held to it bit for bit (tests/test_torch_fused_ingest.py).

The fleet engine runs on the card of ``params.filter_backend``, or on a
one-process mesh's device (parallel/sharding.Mesh), and has the JAX
package's checkpoint surface in its formats: the whole fleet
(:meth:`FleetFusedIngest.snapshot` / :meth:`FleetFusedIngest.restore`)
and one stream's rows (``snapshot_stream`` / ``restore_stream``, schema
version 3, the health supervisor's quarantine transport).  With the fused
mapping route (``fused_mapping_backend='fused'`` + ``map_enable``, which
needs ``deskew_enable``) each stream's MapState rides the ingest state and
is updated inside every tick; ``take_map_wires`` and the ``map_*`` methods
are its surface (mapping/mapper.CarriedFleetMapper is the mapper face).

The fleet engine's serving-pod surface (parallel/service.ElasticFleetService)
is a staging pool shared by the engines of one host (``staging_pool=``) and
the cold reset of a lost shard (:meth:`FleetFusedIngest.capture_cold_template`
once before traffic, :meth:`FleetFusedIngest.cold_reset` in place after).
Its scheduled-serving surface (parallel/scheduler.py) is the rung ladder
(``rungs``, :meth:`FleetFusedIngest.ensure_rungs`, ``submit_backlog(rung=,
overlap_work=)``), the bucket ladder (:meth:`FleetFusedIngest.set_active_bucket`),
the double-buffered staging order (``staging_double_buffer``) and the warm-up
costs precompile times for the latency model.
Every synchronising fetch of these engines — the result copies, the row
snapshot pulls and restores — runs inside ``utils/guards.declared_sync``, so
a steady-state loop under ``utils/guards.steady_state`` lets exactly those
through.

What these engines do NOT do: feed a RawNodeHolder (interval grabs need
host-side nodes) or expose the chain's snapshot surface.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES
from rplidar_ros2_driver_tpu_torch.filters.chain import (
    DEFAULT_BEAMS,
    config_from_params,
    pick_device,
)
from rplidar_ros2_driver_tpu_torch.mapping.mapper import fused_mapping_map_config
from rplidar_ros2_driver_tpu_torch.ops.deskew import deskew_config_from_params
from rplidar_ros2_driver_tpu_torch.ops.filters import FilterState
from rplidar_ros2_driver_tpu_torch.ops.ingest import (
    IngestState,
    create_fleet_ingest_state,
    create_ingest_state,
    fleet_aux_len,
    fleet_fused_ingest_step,
    fleet_ingest_config_for,
    fused_ingest_step,
    fused_ingest_step_counted,
    ingest_config_for,
    super_fleet_ingest_step,
    unpack_fleet_ingest_result,
    unpack_ingest_result,
    unpack_super_fleet_ingest_result,
    warm_revolution_path,
)
from rplidar_ros2_driver_tpu_torch.protocol import crc as crcmod
from rplidar_ros2_driver_tpu_torch.protocol import timing as timingmod
from rplidar_ros2_driver_tpu_torch.protocol.constants import ANS_PAYLOAD_BYTES, Ans
from rplidar_ros2_driver_tpu_torch.utils import cuda_build, guards
from rplidar_ros2_driver_tpu_torch.utils.rowops import gather_row, row_to_numpy, scatter_row

log = logging.getLogger("rplidar_tpu.ingest")

# frame-run bucket sizes (runs are padded up to one; the engine caps a
# run at the largest)
_FUSED_BUCKETS = (4, 64)

# schema version of the PER-STREAM fleet snapshot (snapshot_stream /
# restore_stream), the JAX package's: v2 added the de-skew planes, v3 the
# carried map planes (``ingest.map_*``, fused mapping route only), so the
# quarantine transport moves a stream's map rows with its decode and
# filter rows.  Planes of options that are off are left out.
INGEST_STREAM_SNAPSHOT_VERSION = 3

_MAP_KEYS = ("log_odds", "pose", "origin_xy", "revision")


class StagingPool:
    """Recycled host-side (frames, aux) staging pairs, keyed by staging key:
    uint8 and float32 CPU tensors, page-locked when ``pin`` (so the frame
    upload is asynchronous and the aux plane is read in place).

    Reuse safety is the caller's completion barrier: a pair is ``give``-n
    back only after its dispatch's results were fetched (or, on the card,
    its completion event fired), which proves the device consumed the
    staged inputs.  Thread-safe."""

    def __init__(self, pin: bool = False) -> None:
        self.pin = pin
        self._free: dict = {}
        self._lock = threading.Lock()

    def take(self, key: tuple, shape_b: tuple, shape_a: tuple) -> tuple:
        """A zeroed (frames, aux) pair for ``key``: recycled when a pooled
        pair matches the shapes (stale shapes are dropped), else new."""
        entry = None
        with self._lock:
            free = self._free.setdefault(key, [])
            while free:
                cand = free.pop()
                if tuple(cand[0].shape) == shape_b and tuple(cand[1].shape) == shape_a:
                    entry = cand
                    break
        if entry is not None:
            entry[0].zero_()
            entry[1].zero_()
            return entry
        return (
            torch.zeros(shape_b, dtype=torch.uint8, pin_memory=self.pin),
            torch.zeros(shape_a, dtype=torch.float32, pin_memory=self.pin),
        )

    def give(self, key: tuple, pair: tuple) -> None:
        """Return a pair whose dispatch results were fetched."""
        with self._lock:
            self._free.setdefault(key, []).append(pair)


def _build_kernels(device: torch.device, deskew, mapping=None) -> None:
    """Build the kernels the ingest path launches on the card (nothing to
    build on the CPU): the median kernels, with de-skew B4/B5, with the
    carried map B6/B7/B8."""
    if device.type != "cuda":
        return
    cuda_build.build_libraries(["median"] + (["deskew"] if deskew is not None else [])
                               + (["scan_match"] if mapping is not None else []))


class _Landing:
    """One dispatch's result tensors on their way to the host.

    On the card each result is copied without blocking into a pinned
    buffer recycled through ``pool`` (of ``out_wires`` only the rows of
    the revolutions the step completed), and one CUDA event recorded
    after the copies marks them — and the staged inputs the step read
    before them — done.  On the CPU the results already are host tensors
    and the landing just holds them."""

    def __init__(self, results: tuple, n_completed: int, pool: dict) -> None:
        self._pool = pool
        self.event = None
        if results[0].device.type != "cuda":
            self.host = results
            return
        self.host = []
        for i, t in enumerate(results):
            buf = self._take(tuple(t.shape), t.dtype)
            src, dst = (t[:n_completed], buf[:n_completed]) if i == 1 else (t, buf)
            if src.numel():
                dst.copy_(src, non_blocking=True)
            self.host.append(buf)
        self.event = torch.cuda.Event()
        self.event.record()

    def _take(self, shape: tuple, dtype) -> torch.Tensor:
        free = self._pool.get((shape, dtype))
        return free.pop() if free else torch.empty(shape, dtype=dtype, pin_memory=True)

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> tuple:
        """The results as host arrays, once landed."""
        if self.event is not None:
            with guards.declared_sync():
                self.event.synchronize()
        return tuple(t.numpy() for t in self.host)

    def release(self) -> None:
        """Give the pinned buffers back (only after :meth:`wait`, once
        nothing parsed from them is still a view)."""
        if self.event is not None:
            for t in self.host:
                self._pool.setdefault((tuple(t.shape), t.dtype), []).append(t)
        self.host = ()


def _fill_frames(buf: torch.Tensor, frames: list, expect: int) -> None:
    """Copy ``frames`` (payloads of ``expect`` bytes) into ``buf``'s leading
    rows and columns."""
    m = len(frames)
    buf.numpy()[:m, :expect] = np.frombuffer(b"".join(frames), np.uint8).reshape(m, expect)


class FusedIngest:
    """Producer/consumer engine around ops/ingest.fused_ingest_step."""

    def __init__(
        self,
        params,
        beams: Optional[int] = None,
        *,
        capacity: Optional[int] = None,
        max_revs: int = 2,
        max_queue: int = 32,
        emit_nodes: bool = False,
        buckets: tuple = _FUSED_BUCKETS,
    ) -> None:
        from rplidar_ros2_driver_tpu_torch.utils.backend import maybe_enable_compilation_cache

        maybe_enable_compilation_cache(getattr(params, "compilation_cache_dir", None))
        self.device = pick_device(params.filter_backend)
        self.cfg = config_from_params(params, beams or DEFAULT_BEAMS, platform=self.device.type)
        self._deskew = deskew_config_from_params(params, self.cfg.beams, platform=self.device.type)
        # newest reconstructed sweep (recon_plane (B,) i32, recon_pts (B, 3)
        # f32) of a dispatch that pushed a sub-sweep; ``recon_log=True``
        # also appends each to ``recon_history`` (offline parity only)
        self.last_recon = None
        self.recon_log = False
        self.recon_history: list = []
        self.max_nodes = capacity or MAX_SCAN_NODES
        self.max_revs = max_revs
        self.emit_nodes = emit_nodes
        self._buckets = tuple(sorted(buckets))
        self.timing = timingmod.TimingDesc()
        self.recorder = None
        self._active_ans: Optional[int] = None
        self._icfg = None
        self._state = None
        self._filter_state = None  # survives answer-type switches
        self._lock = threading.Lock()
        # timestamp base of the most recent dispatch (f64, host-side)
        self._base: Optional[float] = None
        self.staging = StagingPool(pin=self.device.type == "cuda")
        # pinned result buffers by (shape, dtype), recycled once parsed
        self._landing_pool: dict = {}
        self._pending: deque = deque()
        # dropped entries whose device work may still be running: their
        # staging pairs and landing buffers go back once their events fire
        self._retiring: list = []
        self._max_queue = max_queue
        self._event = threading.Event()
        self.frames_decoded = 0
        self.nodes_decoded = 0
        self.scans_completed = 0
        self.revs_dropped = 0
        self.wires_dropped = 0
        self.dispatch_count = 0
        # seconds the producer (the transceiver's pump thread, live) spent
        # in staging + the step, summed over dispatches
        self.dispatch_s = 0.0

    # -- stream state ------------------------------------------------------

    def _fresh_filter_state(self):
        return FilterState.for_config(self.cfg, device=self.device)

    def _config_for(self, ans_type: int):
        return ingest_config_for(
            ans_type, self.timing, self.cfg,
            max_nodes=self.max_nodes, max_revs=self.max_revs,
            emit_nodes=self.emit_nodes, deskew=self._deskew,
        )

    def _activate(self, ans_type: int) -> None:
        """Answer type changed: new scan mode — reset decode/assembly
        state, carry the filter window."""
        # graftlint: disable=GL012 — callers (on_measurement_batch,
        # reset_filter) hold self._lock
        self._active_ans = ans_type
        # graftlint: disable=GL012 — callers (on_measurement_batch,
        # reset_filter) hold self._lock
        self._icfg = self._config_for(ans_type)
        filt = (
            self._state.filter if self._state is not None
            else self._filter_state if self._filter_state is not None
            else self._fresh_filter_state()
        )
        # graftlint: disable=GL012 — callers (on_measurement_batch,
        # reset_filter) hold self._lock
        self._state = create_ingest_state(self._icfg, filter_state=filt, device=self.device)

    def reset(self) -> None:
        """Stream-state reset (scan stop/start): clears the partial
        revolution, carries and pending results; the filter window
        survives, like the host chain across a restart."""
        with self._lock:
            if self._state is not None:
                self._filter_state = self._state.filter
            self._state = None
            self._active_ans = None
            self._icfg = None
            self._base = None
            self._retire(self._pending)
            self._pending.clear()
            self._event.clear()
            self.last_recon = None

    def reset_filter(self) -> None:
        """Cold filter reset (the chain.reset() analog)."""
        with self._lock:
            self._filter_state = self._fresh_filter_state()
            if self._state is not None and self._active_ans is not None:
                ans = self._active_ans
                self._active_ans = None
                self._state = None
                self._activate(ans)

    # -- producer side -------------------------------------------------------

    def on_measurement(self, ans_type: int, payload: bytes) -> None:
        """Single-frame compatibility shim (tests / non-batching engines)."""
        self.on_measurement_batch(ans_type, [(payload, time.monotonic())])

    def on_measurement_batch(self, ans_type: int, items: list) -> None:
        """Stage one run of ``(payload, rx_monotonic_ts)`` frames and run
        the fused step on it."""
        rec = self.recorder
        if rec is not None:
            for data, ts in items:
                rec.write(ans_type, data, ts)
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        if expect is None:
            return
        items = [it for it in items if len(it[0]) == expect]
        if not items:
            return
        with self._lock:
            if ans_type != self._active_ans:
                self._activate(ans_type)
            self.frames_decoded += len(items)
            cap = self._buckets[-1]
            for i in range(0, len(items), cap):
                self._dispatch(ans_type, expect, items[i : i + cap])
        self._event.set()

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _retire(self, entries) -> None:
        """Queue dropped entries for recycling (lock held): their staging
        pairs and buffers return once their device work is done."""
        self._retiring.extend(entries)
        self._recycle_retired()

    def _recycle_retired(self) -> None:
        """Recycle the retiring entries whose events fired (lock held);
        never blocks."""
        keep = []
        for entry in self._retiring:
            landing, _icfg, _base, skey, pair = entry
            if landing.done():
                self.staging.give(skey, pair)
                landing.release()
            else:
                keep.append(entry)
        # graftlint: disable=GL012 — callers hold self._lock (see above)
        self._retiring = keep

    # graftlint: hot-loop
    def _dispatch(self, ans_type: int, expect: int, chunk: list) -> None:
        t0 = time.perf_counter()
        m = len(chunk)
        mb = self._bucket(m)
        base = chunk[0][1]
        pair = self.staging.take((mb, expect), (mb, expect), (2 * mb + 2,))
        buf, aux = pair
        _fill_frames(buf, [d for d, _ in chunk], expect)
        a = aux.numpy()
        a[:m] = [ts - base for _, ts in chunk]
        if ans_type == Ans.MEASUREMENT_HQ:
            a[mb : mb + m] = [float(crcmod.frame_crc_ok(d)) for d, _ in chunk]
        a[-2] = 0.0 if self._base is None else self._base - base
        a[-1] = m
        # graftlint: disable=GL012 — under on_measurement_batch's self._lock
        self._base = base
        # graftlint: disable=GL012 — under on_measurement_batch's self._lock
        self._state, res, n_done = fused_ingest_step_counted(
            self._state, buf.to(self.device, non_blocking=True), aux, self._icfg
        )
        landing = _Landing(res, n_done, self._landing_pool)
        self._pending.append((landing, self._icfg, base, (mb, expect), pair))
        self.dispatch_count += 1
        while len(self._pending) > self._max_queue:
            # consumer lagging: oldest result dropped (newest wins)
            self._retire([self._pending.popleft()])
            self.wires_dropped += 1
        self._recycle_retired()
        self.dispatch_s += time.perf_counter() - t0

    def precompile(self, ans_type: int) -> None:
        """Build the path's kernels and warm the step for this format's
        buckets on a throwaway state (there is nothing to compile)."""
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        if expect is None:
            return
        _build_kernels(self.device, self._deskew)
        icfg = self._config_for(ans_type)
        for b in self._buckets:
            st = create_ingest_state(icfg, device=self.device)
            aux = np.zeros((2 * b + 2,), np.float32)
            aux[-1] = 1.0
            frames = torch.zeros((b, expect), dtype=torch.uint8, device=self.device)
            fused_ingest_step(st, frames, aux, icfg)

    # -- consumer side -------------------------------------------------------

    def _parse(self, entry) -> list:
        landing, icfg, base, skey, pair = entry
        res = unpack_ingest_result(landing.wait(), icfg)
        # the results landed, so the staged inputs were consumed; what is
        # kept past this call is copied off the recycled buffers
        for f in ("recon_plane", "recon_pts", "node_ts"):
            if getattr(res, f) is not None:
                setattr(res, f, getattr(res, f).copy())
        with self._lock:
            self.staging.give(skey, pair)
            landing.release()
        if res.recon_pushed:
            self.last_recon = (res.recon_plane, res.recon_pts)
            if self.recon_log:
                self.recon_history.append(self.last_recon)
        self.nodes_decoded += res.nodes_appended
        self.scans_completed += res.n_completed
        self.revs_dropped += res.revs_dropped
        out = []
        for k in range(res.n_completed):
            ts0 = base + float(res.ts0[k])
            duration = max(float(res.end_ts[k]) - float(res.ts0[k]), 0.0)
            out.append((res.outputs[k], ts0, duration))
        return out

    def _pop(self):
        with self._lock:
            if not self._pending:
                self._event.clear()
                return None
            entry = self._pending.popleft()
            if not self._pending:
                self._event.clear()
            return entry

    def wait_and_grab_outputs(self, timeout_s: float = 2.0) -> Optional[list]:
        """Block for the next dispatched batch; returns its completed
        revolutions as ``[(FilterOutput, ts0, duration), ...]`` (possibly
        empty — a mid-revolution batch), or None on timeout.  The batch's
        copy to the host started at dispatch time, so in steady state this
        waits on no device compute."""
        if not self._event.wait(timeout_s):
            return None
        entry = self._pop()
        return None if entry is None else self._parse(entry)

    def collect_nowait(self) -> Optional[list]:
        """Non-blocking variant of :meth:`wait_and_grab_outputs`."""
        entry = self._pop()
        return None if entry is None else self._parse(entry)

    def collect_pipelined(self) -> list:
        """Drain every pending result EXCEPT the newest: the just-
        dispatched batch keeps computing on the device while its
        predecessors, whose results landed during earlier dispatch gaps,
        are parsed on the host (ScanFilterChain.process_raw_pipelined's
        collect-before-dispatch discipline; :meth:`flush` drains the last
        batch at stream end)."""
        out = []
        while True:
            with self._lock:
                if len(self._pending) <= 1:
                    return out
                entry = self._pending.popleft()
            out.extend(self._parse(entry))

    def flush(self) -> list:
        """Parse every pending batch (stream stop): flat list of
        ``(FilterOutput, ts0, duration)`` in dispatch order."""
        out = []
        while True:
            entry = self._pop()
            if entry is None:
                return out
            out.extend(self._parse(entry))


class FleetFusedIngest:
    """Fleet-scale producer/consumer engine around
    ops/ingest.fleet_fused_ingest_step: one staged upload and one step per
    fleet tick, whatever the fleet size.

    Each tick the caller hands every stream's newest raw frame bytes
    (``items[i] = (ans_type, [(payload, rx_monotonic_ts), ...])``, None for
    an idle stream); the engine stacks them into one zero-padded
    ``(streams, M, frame_bytes)`` buffer and threads per-stream format
    branches, decode-state resets and timestamp re-bases through ``aux``.
    Per stream the semantics are the single-stream engine's: a stream
    advances its filter window only on its own completed revolutions.

    ``super_tick_max`` (default ``params.super_tick_max``) enables the
    T-tick super-step: when more than one tick slice is queued (a backlog
    handed to :meth:`submit_backlog`, or one oversized tick split across
    bucket slices), up to T slices are staged as one (T, N, M,
    frame_bytes) plane, uploaded once and run as one super-step; a short
    group is padded with all-idle ticks.

    ``rungs`` is the ladder of drain depths the engine warms (always 1 and
    ``super_tick_max``): a scheduler (parallel/scheduler.py) picks one per
    drain (:meth:`submit_backlog` ``rung=``), and :meth:`precompile` runs
    every (rung, bucket) step once on a throwaway state and times a second
    run (``warmup_costs``), so a rung or bucket switch mid-serving builds
    nothing and maps no new device memory.  ``staging_double_buffer``
    stages drain t+1 while drain t runs; :meth:`set_active_bucket` moves
    the frame-run slicing cap among the warmed buckets.

    ``staging_pool`` injects the :class:`StagingPool` the engine stages its
    uploads through; the serving pod shares one among the engines of a
    host, so an engine carries only device state.  By default the engine
    owns a private pool (pinned on the card)."""

    def __init__(
        self,
        params,
        streams: int,
        *,
        mesh=None,
        beams: Optional[int] = None,
        capacity: Optional[int] = None,
        max_revs: int = 2,
        max_queue: int = 32,
        emit_nodes: bool = False,
        buckets: tuple = _FUSED_BUCKETS,
        super_tick_max: Optional[int] = None,
        staging_pool: Optional[StagingPool] = None,
        rungs: Optional[tuple] = None,
    ) -> None:
        from rplidar_ros2_driver_tpu_torch.ops.deskew import deskew_config_from_params
        from rplidar_ros2_driver_tpu_torch.utils.backend import maybe_enable_compilation_cache

        maybe_enable_compilation_cache(getattr(params, "compilation_cache_dir", None))
        if streams < 1:
            raise ValueError("fleet ingest needs at least one stream")
        self.streams = streams
        self.mesh = mesh
        if mesh is None:
            self.device = pick_device(params.filter_backend)
        elif mesh.spans_processes:
            # the engine runs N independent per-stream pipelines on one
            # device; splitting them across processes is not its layout
            raise ValueError(
                "FleetFusedIngest runs on a one-process mesh; a mesh that "
                "spans processes feeds each process's streams through "
                "ShardedFilterService.submit_local"
            )
        else:
            self.device = mesh.device
        self.cfg = config_from_params(params, beams or DEFAULT_BEAMS, platform=self.device.type)
        self._deskew = deskew_config_from_params(params, self.cfg.beams, platform=self.device.type)
        # the carried SLAM front-end (fused mapping route): each stream's
        # MapState rides the ingest state, updated inside every tick
        self._mapping = fused_mapping_map_config(params, self.cfg.beams, self.device.type)
        if self._mapping is not None and self._deskew is None:
            raise ValueError(
                "fused_mapping_backend='fused' requires deskew_enable "
                "(the carried mapper consumes the reconstructed sweep the "
                "de-skew stage emits every tick)"
            )
        # newest per-stream (7,) int32 map wires of parsed ticks ([live,
        # tx, ty, θidx, score, n_valid, revision]); ``take_map_wires()``
        # drains the fresh ones, like ``take_recon()``
        self.last_map_wires: list = [None] * streams
        self._map_fresh: list = [False] * streams
        # per-stream reconstructed sweeps: ``last_recon[i]`` stream i's
        # newest (plane, pts), ``take_recon()`` drains the fresh ones,
        # ``recon_log=True`` appends every one to ``recon_history[i]``
        self.last_recon: list = [None] * streams
        self._recon_fresh: list = [False] * streams
        self.recon_log = False
        self.recon_history: list = [[] for _ in range(streams)]
        self.max_nodes = capacity or MAX_SCAN_NODES
        self.max_revs = max_revs
        self.emit_nodes = emit_nodes
        if super_tick_max is None:
            super_tick_max = getattr(params, "super_tick_max", 1)
        if super_tick_max < 1:
            raise ValueError("super_tick_max must be >= 1")
        self.super_tick_max = int(super_tick_max)
        # the super-tick RUNG ladder: the drain depths precompile warms,
        # so a scheduler can pick another depth per drain with nothing to
        # build; depth 1 (the per-tick step) is always a rung
        self.rungs = tuple(sorted({1, self.super_tick_max} | {int(r) for r in (rungs or ())}))
        if self.rungs[0] < 1:
            raise ValueError("super-tick rungs must be >= 1")
        # dispatches per rung depth (depth 1 counts per-tick dispatches)
        self.rung_dispatches: dict = {r: 0 for r in self.rungs}
        # set by precompile: extending the ladder afterwards would hand
        # out depths nothing warmed (ensure_rungs refuses); the cold-drain
        # warning fires once per depth
        self._rungs_warmed = False
        self._cold_rungs_warned: set = set()
        self._buckets = tuple(sorted(buckets))
        # double-buffered staging: within a multi-group drain the NEXT
        # group's planes are filled and uploaded after the previous
        # group's step was issued (a ping/pong pair per staging key);
        # off, every group stages then runs, one after another
        self.double_buffer = bool(getattr(params, "staging_double_buffer", True))
        # dispatches whose staging followed an issued step (the
        # /diagnostics staging-overlap counter)
        self.staging_overlap_hits = 0
        # the adaptive bucket ladder's slicing cap (a warmed bucket), None
        # = the largest; a switch only re-slices future ticks
        self.active_bucket: Optional[int] = None
        self.bucket_switches = 0
        # dispatches per (rung, bucket): sums to dispatch_count, its
        # marginal over buckets is rung_dispatches
        self.rung_bucket_dispatches: dict = {}
        # precompile's timed second run of each (rung, bucket) step, in
        # seconds: the LatencyModel's seeds (parallel/scheduler.py)
        self.warmup_costs: dict = {}
        self.timing = timingmod.TimingDesc()
        self.recorder = None
        self._lock = threading.Lock()
        # a staging pair rides its pending entry until the entry's results
        # were fetched (or its event fired), then goes back to the pool
        self.staging = (staging_pool if staging_pool is not None
                        else StagingPool(pin=self.device.type == "cuda"))
        # per-stream host trackers (everything else lives on the device)
        self._stream_fmt: list = [None] * streams   # active ans type
        self._bases: list = [None] * streams        # f64 timestamp base
        self._reset_next: list = [False] * streams  # decode-state reset flags
        self._icfg = None                           # active FleetIngestConfig
        # the cold_reset template: a fresh fleet state on the device,
        # captured only by capture_cold_template (the serving pod's)
        self._fresh = None
        self._state = self._fresh_fleet_state()
        self._pending: deque = deque()
        self._max_queue = max_queue
        self.ticks = 0
        self.dispatch_count = 0
        # staged host->device transfers: two a dispatch (the frames plane
        # here, the aux plane inside the step), whatever the fleet size
        self.h2d_transfers = 0
        self.super_dispatches = 0
        self.ticks_super_fused = 0
        self.frames_decoded = 0
        self.nodes_decoded = 0
        self.scans_completed = 0
        self.revs_dropped = 0
        self.wires_dropped = 0

    def _fresh_fleet_state(self):
        """A fresh fleet state (its shape is format-independent, so the
        baseline single-format config describes every lane)."""
        cfg = fleet_ingest_config_for(
            (Ans.MEASUREMENT,), self.timing, self.cfg,
            max_nodes=self.max_nodes, max_revs=self.max_revs, deskew=self._deskew,
            mapping=self._mapping,
        )
        return create_fleet_ingest_state(cfg, self.streams, device=self.device)

    # -- configuration -------------------------------------------------------

    def _ensure_cfg(self, formats) -> None:
        """(Re)build the static config when the needed format set is not
        covered by the active one; the state is untouched."""
        need = tuple(sorted({int(f) for f in formats if f is not None}))
        if not need:
            return
        if self._icfg is not None and set(need) <= set(self._icfg.formats):
            return
        have = set(self._icfg.formats) if self._icfg is not None else set()
        self._icfg = fleet_ingest_config_for(
            tuple(sorted(have | set(need))), self.timing, self.cfg,
            max_nodes=self.max_nodes, max_revs=self.max_revs,
            emit_nodes=self.emit_nodes, deskew=self._deskew, mapping=self._mapping,
        )

    def ensure_rungs(self, rungs) -> None:
        """Extend the warmed rung ladder (a scheduler attaching to an
        engine already built).  Only BEFORE precompile and traffic: a new
        depth on a live engine would be run for the first time inside the
        serving loop, which the ladder exists to forbid."""
        need = {1} | {int(r) for r in rungs}
        if need <= set(self.rungs):
            return
        if self.ticks > 0 or self._rungs_warmed:
            raise RuntimeError(
                f"cannot extend the rung ladder {self.rungs} with "
                f"{sorted(need - set(self.rungs))} on an engine that "
                "has already "
                + ("ticked" if self.ticks > 0 else "precompiled")
                + " — attach the scheduler BEFORE precompile/traffic"
            )
        if min(need) < 1:
            raise ValueError("super-tick rungs must be >= 1")
        self.rungs = tuple(sorted(set(self.rungs) | need))
        self.rung_dispatches = {r: self.rung_dispatches.get(r, 0) for r in self.rungs}

    def precompile(self, formats, buckets: Optional[tuple] = None) -> None:
        """Build the path's kernels, run a completed revolution's work once
        (ops/ingest.warm_revolution_path), and warm EVERY (rung, bucket) step on
        a throwaway state, through the live staging path: each staging
        key's pair is taken from the pool and given back, the step runs
        once, then a second run is timed into
        ``warmup_costs[(rung, bucket)]`` (the LatencyModel's seed; the
        first run, which builds and maps memory, stays out of it).  Every
        warm run's results stay alive until the end, so the allocator
        holds blocks for a drain's results in flight: a rung or bucket
        switch later builds nothing and maps no new segment."""
        with self._lock:
            self._ensure_cfg(formats)
            icfg = self._icfg
        if icfg is None:
            return
        self._rungs_warmed = True
        _build_kernels(self.device, self._deskew, self._mapping)
        # the warm steps' idle frames complete no revolution: run what a
        # completed one runs (the slot filter, the de-skew profiles) apart
        warm_revolution_path(icfg, self.streams, self.device)
        cuda = self.device.type == "cuda"
        keep = []
        for b in buckets or self._buckets:
            for t_depth in self.rungs:
                skey = ("super", t_depth, b) if t_depth > 1 else ("tick", b)
                buf, aux = pair = self._staging_buffers(skey)
                aux.numpy()[..., 2 * b + 1] = 1.0  # m=1: the live-lane path
                step = super_fleet_ingest_step if t_depth > 1 else fleet_fused_ingest_step
                st = create_fleet_ingest_state(icfg, self.streams, device=self.device)
                keep.append(step(st, buf.to(self.device, non_blocking=True), aux, icfg))
                if cuda:
                    torch.cuda.synchronize(self.device)
                t0 = time.perf_counter()
                keep.append(step(st, buf.to(self.device, non_blocking=True), aux, icfg))
                if cuda:
                    torch.cuda.synchronize(self.device)
                self.warmup_costs[(t_depth, b)] = time.perf_counter() - t0
                self.staging.give(skey, pair)
        del keep

    # -- producer side -------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def set_active_bucket(self, bucket: int) -> None:
        """Move the frame-run slicing cap to ``bucket`` (the scheduler's
        BucketLadder pick).  The bucket must be warmed: precompile ran
        every listed bucket at every rung, so a switch builds nothing.
        The cap only re-slices FUTURE ticks — contents and order never
        change — so any cap sequence is byte-equal by construction."""
        b = int(bucket)
        if b not in self._buckets:
            raise ValueError(
                f"bucket {b} is not a warmed padding bucket "
                f"{self._buckets} — list it in bucket_rungs (every "
                "ladder bucket is warmed per rung at precompile)"
            )
        prev = self.active_bucket or self._buckets[-1]
        self.active_bucket = b
        if b != prev:
            self.bucket_switches += 1

    @property
    def slicing_bucket(self) -> int:
        """The active slicing cap: the bucket ladder's pick, or the
        largest warmed bucket when no ladder has spoken."""
        return self.active_bucket or self._buckets[-1]

    def _normalize_tick(self, items) -> list:
        """Validate one tick's per-stream byte runs: payload-size filter,
        recorder tee, format bookkeeping (a per-stream answer-type change
        resets THAT stream's decode state, filter window carried)."""
        if len(items) != self.streams:
            raise ValueError(f"expected {self.streams} per-stream byte runs, got {len(items)}")
        rec = self.recorder
        runs: list = [None] * self.streams
        for i, item in enumerate(items):
            if not item:
                continue
            ans, frames = item
            expect = ANS_PAYLOAD_BYTES.get(ans)
            if expect is None:
                continue
            if rec is not None:
                for data, ts in frames:
                    rec.write(ans, data, ts)
            frames = [it for it in frames if len(it[0]) == expect]
            if not frames:
                continue
            if self._stream_fmt[i] != ans:
                self._stream_fmt[i] = ans
                # the timestamp base is cleared when the reset lands, in
                # slice order (_stage_slice), not here: a backlog
                # normalizes every tick before any is staged
                self._reset_next[i] = True
            runs[i] = (int(ans), frames)
            self.frames_decoded += len(frames)
        return runs

    def _tick_slices(self, items) -> list:
        """One tick's bucket-capped lockstep slices (several when a stream
        delivered more frames than the largest bucket); [] for a pure idle
        tick with no pending reset.  Each slice is ``(chunk, fmts,
        resets)`` with the format and reset snapshots baked in."""
        runs = self._normalize_tick(items)
        self._ensure_cfg(list(self._stream_fmt))
        if self._icfg is None:
            return []  # nothing ever streamed
        longest = max((len(r[1]) for r in runs if r), default=0)
        if longest == 0 and not any(self._reset_next):
            return []
        self.ticks += 1
        fmts = list(self._stream_fmt)
        resets = self._reset_next
        self._reset_next = [False] * self.streams
        no_reset = [False] * self.streams
        # the bucket ladder's slicing cap: a collapsed fleet slices at a
        # small warmed bucket, a full one at the largest
        cap = self.slicing_bucket
        slices = []
        off = 0
        while True:
            chunk = [(r[0], r[1][off : off + cap]) if r else None for r in runs]
            if off and not any(c and c[1] for c in chunk):
                break
            slices.append((chunk, fmts, resets if off == 0 else no_reset))
            off += cap
            if off >= longest:
                break
        return slices

    def _dispatch_slices(self, slices, depth: Optional[int] = None) -> None:
        """Dispatch a queue of tick slices: one per-tick step each at depth
        1 (or for a single queued slice), else groups of up to ``depth``
        slices per super-step.  The default depth is ``super_tick_max``; a
        scheduler picks another WARMED rung per drain — an unwarmed depth
        is refused, since it would run for the first time inside the
        serving loop.

        With ``staging_double_buffer`` on and more than one group queued,
        staging runs one group AHEAD: group t's step is issued, THEN group
        t+1's planes are filled and uploaded, while the card still runs
        t's work.  Groups stage strictly in tick order, so the timestamp
        bases and the pending queue see the same sequence either way."""
        if depth is None:
            depth = self.super_tick_max
        elif depth not in self.rungs:
            raise ValueError(
                f"drain depth {depth} is not a warmed rung "
                f"{self.rungs} — extend sched_rungs (ensure_rungs) "
                "before traffic"
            )
        elif depth > 1 and not self._rungs_warmed and depth not in self._cold_rungs_warned:
            # a LISTED rung on an engine precompile never warmed: fine for
            # offline tools and tests, a latency spike in a serving loop
            self._cold_rungs_warned.add(depth)
            log.warning("rung-%d drain on an engine precompile() never warmed — "
                        "this dispatch runs its step for the first time", depth)
        if depth <= 1:
            groups = [[sl] for sl in slices]
        else:
            groups = [slices[off : off + depth] for off in range(0, len(slices), depth)]

        def stage(group):
            if len(group) == 1:
                return self._stage_tick(group[0])
            return self._stage_super(group, depth)

        if not self.double_buffer or len(groups) < 2:
            for group in groups:
                self._launch(stage(group))
            return
        staged = stage(groups[0])
        for group in groups[1:]:
            self._launch(staged)   # drain t is issued
            staged = stage(group)  # drain t+1 stages behind it
            self.staging_overlap_hits += 1
        self._launch(staged)

    # graftlint: hot-loop
    def _stage_slice(self, sl, mb: int, buf: torch.Tensor, aux: np.ndarray) -> None:
        """Fill one tick slice's staging planes (``buf`` (streams, mb,
        frame_bytes) uint8, ``aux`` (streams, 2mb+4) f32, pre-zeroed),
        advancing the per-stream timestamp bases."""
        icfg = self._icfg
        chunk, fmts, resets = sl
        for i, c in enumerate(chunk):
            fmt = fmts[i]
            if fmt is not None:
                aux[i, 2 * mb + 2] = icfg.formats.index(int(fmt))
            if resets[i]:
                aux[i, 2 * mb + 3] = 1.0
                self._bases[i] = None  # decode reset => fresh timestamp base
            if not c or not c[1]:
                continue  # idle this slice: m=0, carries pass through
            ans, frames = c
            m = len(frames)
            base = frames[0][1]
            _fill_frames(buf[i], [d for d, _ in frames], ANS_PAYLOAD_BYTES[Ans(ans)])
            aux[i, :m] = [ts - base for _, ts in frames]
            if ans == Ans.MEASUREMENT_HQ:
                aux[i, mb : mb + m] = [float(crcmod.frame_crc_ok(d)) for d, _ in frames]
            aux[i, 2 * mb] = 0.0 if self._bases[i] is None else self._bases[i] - base
            aux[i, 2 * mb + 1] = m
            self._bases[i] = base

    def _staging_buffers(self, skey: tuple) -> tuple:
        fb = self._icfg.frame_bytes
        mb = skey[-1]
        lead = (skey[1],) if skey[0] == "super" else ()
        return self.staging.take(
            skey, lead + (self.streams, mb, fb), lead + (self.streams, fleet_aux_len(mb))
        )

    def _slice_bucket(self, slices) -> int:
        return self._bucket(max((len(c[1]) for sl in slices for c in sl[0] if c), default=1))

    # graftlint: hot-loop
    def _stage_tick(self, sl) -> tuple:
        """Fill and upload ONE per-tick step's frames (the aux plane stays
        in pinned host memory; the step uploads it)."""
        mb = self._slice_bucket([sl])
        skey = ("tick", mb)
        pair = self._staging_buffers(skey)
        buf, aux = pair
        self._stage_slice(sl, mb, buf, aux.numpy())
        self.h2d_transfers += 2
        return ("tick", 1, 1, self._icfg, list(self._bases), skey, pair,
                buf.to(self.device, non_blocking=True))

    # graftlint: hot-loop
    def _stage_super(self, group, t_depth: int) -> tuple:
        """Fill and upload one super-step's (T, streams, M, frame_bytes)
        planes; ticks beyond the group stay all-idle (zeroed)."""
        mb = self._slice_bucket(group)
        skey = ("super", t_depth, mb)
        pair = self._staging_buffers(skey)
        buf, aux = pair
        a = aux.numpy()
        bases_per_tick = []
        for t, sl in enumerate(group):
            self._stage_slice(sl, mb, buf[t], a[t])
            bases_per_tick.append(list(self._bases))
        self.h2d_transfers += 2
        return ("super", t_depth, len(group), self._icfg, bases_per_tick, skey, pair,
                buf.to(self.device, non_blocking=True))

    # graftlint: hot-loop
    def _launch(self, staged) -> None:
        """Run the step of one staged descriptor and queue its results
        (with, on the card, the event that marks the staged inputs read)."""
        kind, t_depth, n, icfg, bases, skey, pair, dbuf = staged
        step = super_fleet_ingest_step if kind == "super" else fleet_fused_ingest_step
        self._state, *res = step(self._state, dbuf, pair[1], icfg)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        if kind == "super":
            self.super_dispatches += 1
            self.ticks_super_fused += n
        self.dispatch_count += 1
        self.rung_dispatches[t_depth] = self.rung_dispatches.get(t_depth, 0) + 1
        rb = (t_depth, skey[-1])
        self.rung_bucket_dispatches[rb] = self.rung_bucket_dispatches.get(rb, 0) + 1
        self._pending.append((kind, tuple(res), icfg, bases, skey, pair, event))
        while len(self._pending) > self._max_queue:
            self._release_entry(self._pending.popleft())
            self.wires_dropped += 1

    def _release_entry(self, entry) -> None:
        """Give an unparsed entry's staging pair back to the pool once the
        device has read it (its event; on the CPU the step already has)."""
        event = entry[6]
        if event is not None:
            with guards.declared_sync():
                event.synchronize()
        self.staging.give(entry[4], entry[5])

    # -- consumer side -------------------------------------------------------

    def _parse_entries(self, entries) -> list:
        """Per-stream ``(FilterOutput, ts0, duration)`` lists across the
        given dispatch entries, in dispatch order (a super entry's idle pad
        ticks parse to empty rows)."""
        out: list = [[] for _ in range(self.streams)]

        def absorb(results, bases):
            for i, res in enumerate(results):
                if res.recon_pushed:
                    self.last_recon[i] = (res.recon_plane, res.recon_pts)
                    self._recon_fresh[i] = True
                    if self.recon_log:
                        self.recon_history[i].append(self.last_recon[i])
                if res.map_wire is not None:
                    # every mapping tick emits a wire (an idle one with
                    # live = 0): newest wins, take_map_wires drains it
                    self.last_map_wires[i] = res.map_wire
                    self._map_fresh[i] = True
                self.nodes_decoded += res.nodes_appended
                self.scans_completed += res.n_completed
                self.revs_dropped += res.revs_dropped
                base = bases[i]
                for k in range(res.n_completed):
                    ts0 = (base or 0.0) + float(res.ts0[k])
                    dur = max(float(res.end_ts[k]) - float(res.ts0[k]), 0.0)
                    out[i].append((res.outputs[k], ts0, dur))

        for kind, arrays, icfg, bases, skey, pair, _event in entries:
            # the declared fetch: the results' copy to the host waits on
            # the step, which also proves the staged inputs were read
            with guards.declared_sync():
                parsed = (unpack_super_fleet_ingest_result(arrays, icfg) if kind == "super"
                          else [unpack_fleet_ingest_result(arrays, icfg)])
            for t, results in enumerate(parsed):
                # a super entry's pad ticks complete nothing; the last
                # tick's bases cover them
                absorb(results, bases[min(t, len(bases) - 1)] if kind == "super" else bases)
            self.staging.give(skey, pair)
        return out

    def take_recon(self) -> list:
        """Drain the FRESH reconstructed sweeps since the last call: one
        ``(recon_plane, recon_pts)`` or None per stream."""
        out = []
        with self._lock:
            for i in range(self.streams):
                out.append(self.last_recon[i] if self._recon_fresh[i] else None)
                self._recon_fresh[i] = False
        return out

    def take_map_wires(self) -> list:
        """Drain the fresh carried-map wires since the last call: one (7,)
        int32 ``[live, tx_sub, ty_sub, theta_idx, score, n_valid,
        revision]`` or None per stream (None = no mapping tick parsed
        since, unlike a parsed tick whose ``live`` is 0)."""
        out = []
        with self._lock:
            for i in range(self.streams):
                out.append(self.last_map_wires[i] if self._map_fresh[i] else None)
                self._map_fresh[i] = False
        return out

    def submit(self, items) -> list:
        """One blocking fleet tick: run this tick's bytes and return every
        pending revolution as per-stream lists of ``(FilterOutput, ts0,
        duration)``, in dispatch order."""
        with self._lock:
            self._dispatch_slices(self._tick_slices(items))
            entries = list(self._pending)
            self._pending.clear()
            return self._parse_entries(entries)

    def submit_backlog(self, ticks, *, rung: Optional[int] = None, overlap_work=None) -> list:
        """Drain a BACKLOG of queued fleet ticks in ``ceil(slices/T)``
        super-steps; T is ``super_tick_max``, or ``rung`` (another WARMED
        depth — the scheduler's pick; an unwarmed one is refused).  Ticks
        are normalized in order and the result is exact against
        submitting them one by one, for any rung sequence.

        ``overlap_work`` (a zero-argument callable) runs after every
        dispatch is issued and before any result is parsed, outside the
        engine lock: the serving pod's snapshot pulls and tile publication
        ride there.  A row gather it queues runs after the drain's steps
        on the same stream, so it sees the post-drain state."""
        with self._lock:
            slices = []
            for items in ticks:
                slices.extend(self._tick_slices(items))
            self._dispatch_slices(slices, depth=rung)
        if overlap_work is not None:
            overlap_work()
        with self._lock:
            entries = list(self._pending)
            self._pending.clear()
            return self._parse_entries(entries)

    def submit_pipelined(self, items) -> list:
        """Parse the PREVIOUS ticks' results, then run THIS tick's bytes
        and return the previous outputs (one tick of declared staleness;
        :meth:`flush` drains the last tick)."""
        with self._lock:
            entries = list(self._pending)
            self._pending.clear()
            out = self._parse_entries(entries)
            self._dispatch_slices(self._tick_slices(items))
            return out

    def flush(self) -> list:
        """Parse every pending result (fleet stop)."""
        with self._lock:
            entries = list(self._pending)
            self._pending.clear()
            return self._parse_entries(entries)

    def reset(self) -> None:
        """Fleet stream-state reset (scan stop/start): every stream's
        decode carries reset at the next step, pending results dropped;
        the rolling filter windows survive."""
        with self._lock:
            self._drop_pending()
            self._stream_fmt = [None] * self.streams
            self._bases = [None] * self.streams
            self._reset_next = [True] * self.streams
            self.last_recon = [None] * self.streams
            self._recon_fresh = [False] * self.streams
            # the carried maps survive a stream reset (scan stop/start
            # resets decode, not the map); only stale wires go
            self.last_map_wires = [None] * self.streams
            self._map_fresh = [False] * self.streams

    def filter_state_of(self, i: int):
        """Stream ``i``'s FilterState, copied to the host."""
        fs = self._state.filter

        return FilterState(**{
            f.name: None if getattr(fs, f.name) is None else getattr(fs, f.name)[i].cpu()
            for f in dataclasses.fields(fs)
        })

    # -- the serving surface (ShardedFilterService, the serving pod) ---------

    def snapshot(self) -> dict:
        """Host snapshot of the WHOLE per-stream ingest state — decode
        carries, partial revolutions, rolling filter windows, carried maps
        (cloned: the step updates them in place) — plus the host-side
        trackers, in the JAX package's format: ``ingest.*`` /
        ``filter.*`` stream-batched numpy planes, ``formats`` (int32, -1 =
        never streamed), ``bases`` (f64, nan = none).  ``median_sorted`` is
        derived and excluded (restore recomputes it).  The device copy is
        taken under the lock, the host copy after it."""
        with self._lock:
            st = self._state
            ing = {
                f.name: getattr(st, f.name).clone()
                for f in dataclasses.fields(st)
                if f.name != "filter" and getattr(st, f.name) is not None
            }
            filt = {
                f.name: getattr(st.filter, f.name).clone()
                for f in dataclasses.fields(st.filter)
                if f.name != "median_sorted" and getattr(st.filter, f.name) is not None
            }
            formats = np.asarray([-1 if f is None else int(f) for f in self._stream_fmt],
                                 np.int32)
            bases = np.asarray([np.nan if b is None else float(b) for b in self._bases],
                               np.float64)
        snap = {f"ingest.{k}": v.cpu().numpy() for k, v in ing.items()}
        snap.update({f"filter.{k}": v.cpu().numpy() for k, v in filt.items()})
        snap["formats"] = formats
        snap["bases"] = bases
        return snap

    def restore(self, snap: dict) -> bool:
        """Restore a :meth:`snapshot` (either package's).  A stream-count,
        geometry or ingest-key-space mismatch (the de-skew planes
        included) is rejected with the current state untouched; pending
        results are dropped on success (pre-restore outputs must never
        publish).  The upload copies the snapshot's arrays."""
        from rplidar_ros2_driver_tpu_torch.ops.filters import recompute_median_sorted

        try:
            formats = np.asarray(snap["formats"])
            bases = np.asarray(snap["bases"])
            ing = {k[len("ingest."):]: np.asarray(v)
                   for k, v in snap.items() if k.startswith("ingest.")}
            filt = {k[len("filter."):]: np.asarray(v)
                    for k, v in snap.items() if k.startswith("filter.")}
        except KeyError:
            return False
        if formats.shape != (self.streams,) or ing.get(
            "partial", np.empty(0)
        ).shape != (self.streams, self.max_nodes, 4):
            log.warning("rejecting incompatible fleet ingest snapshot "
                        "(streams/geometry mismatch)")
            return False
        st = self._state
        expected_ing = {
            f.name: tuple(getattr(st, f.name).shape)
            for f in dataclasses.fields(st)
            if f.name != "filter" and getattr(st, f.name) is not None
        }
        got_ing = {k: tuple(v.shape) for k, v in ing.items()}
        if expected_ing != got_ing:
            log.warning("rejecting incompatible fleet ingest snapshot "
                        "(ingest planes %s != %s)", got_ing, expected_ing)
            return False
        expected_filter = {
            k: (self.streams, *v)
            for k, v in FilterState.shapes(self.cfg.window, self.cfg.beams, self.cfg.grid).items()
        }
        got_filter = {k: tuple(v.shape) for k, v in filt.items()}
        if expected_filter != got_filter:
            log.warning("rejecting incompatible fleet ingest snapshot "
                        "(filter geometry %s != %s)", got_filter, expected_filter)
            return False

        def up(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
            # a host copy: a CPU from_numpy would share the caller's buffer
            return torch.from_numpy(np.array(arr)).to(device=self.device, dtype=like.dtype)

        fstate = FilterState(
            **{k: up(v, getattr(st.filter, k)) for k, v in filt.items()}, median_sorted=None,
        )
        state = IngestState(filter=fstate, **{k: up(v, getattr(st, k)) for k, v in ing.items()})
        if self.cfg.median_backend.startswith("inc"):
            state.filter.median_sorted = recompute_median_sorted(state.filter.range_window)
        with self._lock:
            self._state = state
            self._stream_fmt = [None if f < 0 else int(f) for f in formats]
            self._bases = [None if np.isnan(b) else float(b) for b in bases]
            self._reset_next = [False] * self.streams
            self._drop_pending()
        return True

    def _drop_pending(self) -> None:
        """Drop every unparsed result (lock held), their staging pairs
        back to the pool once the device has read them."""
        while self._pending:
            self._release_entry(self._pending.popleft())

    # -- per-stream checkpoint surface (quarantine/rejoin, migration) -------

    def _check_stream(self, i: int) -> None:
        if not (0 <= i < self.streams):
            raise IndexError(f"stream {i} out of range [0, {self.streams})")

    def snapshot_stream(self, i: int) -> dict:
        """One stream's rows of the fleet state in the JAX package's
        schema-versioned format: ``ingest.*`` (the carried map's
        ``ingest.map_*`` on the fused mapping route) and ``filter.*`` rows,
        ``format``, ``base``, ``version`` — the health supervisor's
        quarantine checkpoint.  Row-sized traffic: one row gather on the
        device under the lock, its copy to the host after it."""
        self._check_stream(i)
        with self._lock:
            row = gather_row(self._state, i)
            fmt = self._stream_fmt[i]
            base = self._bases[i]
        with guards.declared_sync():  # the row's copy to the host
            host = row_to_numpy(row)
        filt = host.pop("filter")
        filt.pop("median_sorted", None)  # derived; restore recomputes it
        snap = {f"ingest.{k}": v for k, v in host.items()}
        snap.update({f"filter.{k}": v for k, v in filt.items()})
        snap["format"] = np.asarray(-1 if fmt is None else int(fmt), np.int32)
        snap["base"] = np.asarray(np.nan if base is None else float(base), np.float64)
        snap["version"] = np.asarray(INGEST_STREAM_SNAPSHOT_VERSION, np.int32)
        return snap

    def restore_stream(self, i: int, snap: dict, *, restore_decode: bool = False) -> bool:
        """Install a :meth:`snapshot_stream` into lane ``i`` with every
        other stream's rows and the pending results untouched.

        By default the rolling filter window is restored and the decode
        carries are RESET at the lane's next tick (a rejoin after
        quarantine re-enters the byte stream mid-capsule: the host path's
        decoder + assembler reset with the chain carried through); the
        carried map row stays the lane's own.  ``restore_decode=True``
        also restores every ``ingest.*`` row, the map's included (a live
        stream moved between engines), and needs the snapshot's ingest key
        space to match this engine's exactly.  A version or geometry
        mismatch is rejected with the state untouched."""
        from rplidar_ros2_driver_tpu_torch.ops.filters import recompute_median_sorted

        self._check_stream(i)
        ver = int(np.asarray(snap.get("version", -1)))
        if ver != INGEST_STREAM_SNAPSHOT_VERSION:
            log.warning("rejecting stream snapshot with schema version %s (want %d)",
                        snap.get("version"), INGEST_STREAM_SNAPSHOT_VERSION)
            return False
        expected_filter = FilterState.shapes(self.cfg.window, self.cfg.beams, self.cfg.grid)
        got_filter = {k[len("filter."):]: tuple(np.asarray(v).shape)
                      for k, v in snap.items() if k.startswith("filter.")}
        if expected_filter != got_filter:
            log.warning("rejecting incompatible stream snapshot (filter geometry %s != %s)",
                        got_filter, expected_filter)
            return False
        with self._lock:
            st = self._state
            ing_rows = {}
            if restore_decode:
                # the key space must cover THIS engine's state exactly: a
                # snapshot without the de-skew or map planes would leave
                # the lane's previous occupant's rows in place
                cur = {f.name: tuple(getattr(st, f.name).shape[1:])
                       for f in dataclasses.fields(st)
                       if f.name != "filter" and getattr(st, f.name) is not None}
                got_keys = {k for k in snap if k.startswith("ingest.")}
                if got_keys != {f"ingest.{k}" for k in cur}:
                    log.warning("rejecting incompatible stream snapshot (ingest keys %s != %s)",
                                sorted(got_keys), sorted(f"ingest.{k}" for k in cur))
                    return False
                for k, shape in cur.items():
                    row = np.asarray(snap[f"ingest.{k}"])
                    if row.shape != shape:
                        log.warning("rejecting incompatible stream snapshot "
                                    "(ingest %s row %s != %s)", k, row.shape, shape)
                        return False
                    ing_rows[k] = row
            with guards.declared_sync():  # the rows' upload
                scatter_row(st.filter, {k: snap[f"filter.{k}"] for k in expected_filter}, i)
                if st.filter.median_sorted is not None:
                    st.filter.median_sorted[i].copy_(
                        recompute_median_sorted(st.filter.range_window[i]))
                scatter_row(st, ing_rows, i)
            fmt = int(np.asarray(snap.get("format", -1)))
            self._stream_fmt[i] = None if fmt < 0 else fmt
            if restore_decode:
                base = float(np.asarray(snap.get("base", np.nan)))
                self._bases[i] = None if np.isnan(base) else base
                self._reset_next[i] = False
            else:
                self._bases[i] = None
                self._reset_next[i] = True
        return True

    def capture_cold_template(self) -> None:
        """Capture the :meth:`cold_reset` template: a fresh fleet state on
        the engine's device, kept for the engine's lifetime.  The serving
        pod calls this at precompile, before traffic, so the allocation
        never lands inside a guarded loop; engines that are never
        cold-reset skip the memory."""
        if self._fresh is None:
            self._fresh = self._fresh_fleet_state()

    def cold_reset(self) -> None:
        """Device-loss reinitialisation — the serving pod's shard-kill and
        re-admission entry point (parallel/service.ElasticFleetService):
        every lane's state becomes the fresh template and every host
        tracker is cleared, as if the engine had just been built on a
        rebooted card.  Unlike :meth:`reset` (scan stop/start, filter
        windows survive) nothing survives.

        The template is copied INTO the existing state tensors: no new
        device memory inside a guarded loop, and a view of the carry (the
        carried MapState's planes) stays valid.  Unparsed results are
        dropped, their staging pairs given back to the (shared) pool once
        the device has read them."""
        if self._fresh is None:
            raise RuntimeError(
                "capture_cold_template() must run before cold_reset() "
                "(the serving pod captures it at precompile, before traffic)"
            )
        with self._lock:
            self._drop_pending()
            _copy_state(self._state, self._fresh)
            self._stream_fmt = [None] * self.streams
            self._bases = [None] * self.streams
            self._reset_next = [False] * self.streams
            # host mirrors of the wiped device state restart with it: the
            # sub-sweep cache and the carried map's wires
            self.last_recon = [None] * self.streams
            self._recon_fresh = [False] * self.streams
            self.last_map_wires = [None] * self.streams
            self._map_fresh = [False] * self.streams

    # -- the carried map surface (mapping/mapper.CarriedFleetMapper) ---------

    def _require_mapping(self) -> None:
        if self._mapping is None:
            raise RuntimeError(
                "this engine carries no map (the fused mapping route is off — "
                "fused_mapping_backend)"
            )

    def map_snapshot(self) -> dict:
        """Host copy of every stream's carried MapState in FleetMapper's
        snapshot keys (stream-batched ``log_odds``/``pose``/``origin_xy``/
        ``revision``), so the two routes' map checkpoints interoperate."""
        self._require_mapping()
        with self._lock:
            planes = {k: getattr(self._state, f"map_{k}").clone() for k in _MAP_KEYS}
        with guards.declared_sync():
            return {k: v.cpu().numpy() for k, v in planes.items()}

    def map_restore(self, core: dict) -> None:
        """Install stream-batched MapState planes into the carry (shapes
        checked by the caller, CarriedFleetMapper)."""
        self._require_mapping()
        with self._lock, guards.declared_sync():
            for k in _MAP_KEYS:
                cur = getattr(self._state, f"map_{k}")
                cur.copy_(torch.from_numpy(np.array(core[k])).reshape(cur.shape))

    def map_snapshot_stream(self, i: int) -> dict:
        """One stream's carried MapState row (FleetMapper's keys)."""
        self._require_mapping()
        self._check_stream(i)
        with self._lock:
            rows = {k: getattr(self._state, f"map_{k}")[i].clone() for k in _MAP_KEYS}
        with guards.declared_sync():
            return {k: v.cpu().numpy() for k, v in rows.items()}

    def map_restore_stream(self, i: int, core: dict) -> None:
        """Install one stream's MapState row into the carry, every other
        stream and this stream's decode and filter rows untouched."""
        self._require_mapping()
        self._check_stream(i)
        with self._lock, guards.declared_sync():
            scatter_row(self._state, {f"map_{k}": core[k] for k in _MAP_KEYS}, i)

    def map_reanchor_stream(self, i: int, pose: np.ndarray) -> None:
        """Rewrite one stream's carried front-end pose (the loop-closure
        re-anchor, FleetMapper.reanchor_stream's carried twin)."""
        self._require_mapping()
        self._check_stream(i)
        with self._lock, guards.declared_sync():
            scatter_row(self._state, {"map_pose": np.asarray(pose, np.int32)}, i)


def _copy_state(dst, src) -> None:
    """Copy every tensor of ``src`` into the matching tensor of ``dst`` in
    place (dataclasses of tensors, nested ones included; None planes on
    both sides)."""
    for f in dataclasses.fields(dst):
        d, v = getattr(dst, f.name), getattr(src, f.name)
        if dataclasses.is_dataclass(d):
            _copy_state(d, v)
        elif d is not None:
            d.copy_(v)
