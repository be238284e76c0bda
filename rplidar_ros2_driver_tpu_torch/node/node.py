"""RPlidarNode — the top-level lifecycle node.

Behavioral mirror of the reference node (src/rplidar_node.cpp) and of the
JAX package's node:

  * on_configure  — load params, build the driver factory, set up
    publishing + static TF + diagnostics, build the filter chain
    (:116-211)
  * on_activate   — spawn the scan-loop FSM thread (:213-225)
  * on_deactivate — stop the thread, stop the motor (:227-242)
  * on_cleanup    — drop driver + chain state (:244-256)
  * dynamic reconfigure — rpm / scan_processing / scan_mode at runtime
    (:689-774), rejected while disconnected

When ``filter_chain`` stages are configured, each revolution runs through
the ScanFilterChain between grab and publish (on the card unless
``filter_backend: cpu``); the LaserScan then carries the temporal-median
ranges and a PointCloud + voxel grid are published alongside.  With an
empty chain the raw path converts the revolution with ``to_laserscan`` on
the same device.

Ingest seam (``ingest_backend``): ``host`` grabs assembled revolutions
from the driver and runs the chain here (the path above); ``fused`` hands
the driver a FusedIngest sink instead — raw frame bytes decode, segment
into revolutions and filter on the device (ops/ingest.py, de-skew with
kernels B4/B5 when ``deskew_enable``), and the FSM publishes the already
filtered outputs via :meth:`RPlidarNode._on_filtered_output`.

With ``map_enable`` the SLAM front-end mapper (mapping/mapper.FleetMapper,
one stream) takes every chain output: each revolution is matched against
the log-odds map and absorbed into it, and a ``PoseHost`` is published
beside the scan.  On the card the mapper is the fused device path with
the matcher kernels B6/B7/B8; with ``filter_backend: cpu`` it is the host
reference.  The map survives deactivate/activate and rides the combined
checkpoint under ``mapper.*`` keys.

With ``loop_enable`` as well, the SLAM back-end (slam/loop.
LoopClosureEngine) observes every mapper tick: submap finalizations,
closure checks (on the card, kernels B6/B7 score the candidates) and the
pose-graph relaxation; the published ``PoseHost`` is then the
pose-graph-corrected pose.  The submap library survives
deactivate/activate and rides the combined checkpoint under ``loop.*``
keys, in the JAX package's format.

The driver is driver/real.RealLidarDriver over the native channel
(serial, TCP or UDP) unless ``dummy_mode`` is set.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
from rplidar_ros2_driver_tpu_torch.filters.chain import (
    ScanFilterChain,
    pick_device,
    resolve_ingest_backend,
)
from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
from rplidar_ros2_driver_tpu_torch.node.fsm import DriverState, FsmTimings, ScanLoopFsm
from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleNode, LifecycleState
from rplidar_ros2_driver_tpu_torch.node.messages import (
    LaserScanHost,
    PointCloudHost,
    PoseHost,
    StaticTransform,
)
from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher, PublisherBase
from rplidar_ros2_driver_tpu_torch.ops.ascend import apply_angle_compensation
from rplidar_ros2_driver_tpu_torch.ops.laserscan import to_laserscan
from rplidar_ros2_driver_tpu_torch.ops.scan_match import pose_to_metric
from rplidar_ros2_driver_tpu_torch.utils.tracing import StageTimer

log = logging.getLogger("rplidar_tpu.node")

# combined-checkpoint key prefixes: the mapper's MapState and the loop
# engine's LoopState, each schema-versioned by its own "version" entry
_MAPPER_KEY_PREFIX = "mapper."
_LOOP_KEY_PREFIX = "loop."


class RPlidarNode(LifecycleNode):
    def __init__(
        self,
        params: Optional[DriverParams] = None,
        publisher: Optional[PublisherBase] = None,
        *,
        driver_factory=None,
        fsm_timings: Optional[FsmTimings] = None,
        name: str = "rplidar_node",
    ) -> None:
        super().__init__(name)
        self.params = params or DriverParams()
        self.params.validate()
        self.publisher = publisher or CollectingPublisher()
        self._driver_factory = driver_factory
        self._fsm_timings = fsm_timings
        self.fsm: Optional[ScanLoopFsm] = None
        self.chain: Optional[ScanFilterChain] = None
        # device of the raw publish path (filter_chain empty)
        self.raw_device = None
        # fused ingest engine (ingest_backend="fused"): owns the filter
        # window in place of self.chain; survives FSM driver recreation
        # (each recreated driver gets the same sink re-attached)
        self.fused_ingest = None
        self.diagnostics: Optional[DiagnosticsUpdater] = None
        self.tracer = StageTimer()
        self._param_lock = threading.Lock()
        self._chain_snapshot = None
        # SLAM front-end (map_enable): one-stream mapper fed every chain
        # output; its snapshot survives deactivate/activate and cleanup
        self.mapper = None
        self._mapper_snapshot = None
        # SLAM back-end (loop_enable): submap library + loop closure +
        # pose graph beside the mapper; observes every mapper tick and
        # republishes the corrected pose
        self.loop = None
        self._loop_snapshot = None
        # (stamp, duration, max_range) of the revolution whose chain
        # output is still in flight when pipelined_publish is on
        self._pipeline_meta: Optional[tuple[float, float, float]] = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _default_factory(self):
        if self.params.dummy_mode:
            return DummyLidarDriver()
        from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver

        return RealLidarDriver(
            channel_type=self.params.channel_type,
            tcp_host=self.params.tcp_host,
            tcp_port=self.params.tcp_port,
            udp_host=self.params.udp_host,
            udp_port=self.params.udp_port,
        )

    def _resolve_fused_ingest(self) -> bool:
        """Whether this configure builds the fused ingest seam.  Fused
        needs the filter chain AND a wire-streaming driver: the dummy
        driver synthesizes host scans above the protocol layer, so it
        falls back to the host backend with a notice."""
        backend = resolve_ingest_backend(self.params.ingest_backend)
        if backend != "fused" or not self.params.filter_chain:
            if getattr(self.params, "deskew_enable", False):
                raise ValueError(
                    "deskew_enable requires this node's ingest seam to "
                    f"resolve fused (ingest_backend="
                    f"{self.params.ingest_backend!r} resolved "
                    f"{backend!r}) — de-skew/reconstruction runs inside "
                    "the fused ingest program only"
                )
            return False
        if self.params.dummy_mode and self._driver_factory is None:
            log.warning(
                "ingest_backend='fused' needs a wire-streaming driver; "
                "dummy_mode synthesizes scans above the protocol layer — "
                "falling back to the host ingest path"
            )
            return False
        return True

    def on_configure(self) -> bool:
        log.info("%s: configuring (port=%s)", self.name, self.params.serial_port)
        # the kernel build cache first, ahead of any engine or chain that
        # builds hot-path kernels: a warm restart loads them, no nvcc
        from rplidar_ros2_driver_tpu_torch.utils.backend import maybe_enable_compilation_cache

        maybe_enable_compilation_cache(self.params.compilation_cache_dir)
        if self._driver_factory is None and not self.params.dummy_mode:
            # probe the native I/O library here, not inside the scan thread:
            # when it cannot be built/loaded the driver falls back to the
            # pure-Python transport (protocol/pytransport.py), which works
            # but loses the SCHED_RR rx elevation — worth one loud notice
            from rplidar_ros2_driver_tpu_torch import native

            if not native.available():
                log.warning("native I/O library unavailable (g++ over "
                            "native/src); real driver will use the "
                            "pure-Python transport fallback")
        factory = self._driver_factory or self._default_factory
        fused = self._resolve_fused_ingest()
        if fused:
            from rplidar_ros2_driver_tpu_torch.driver.ingest import FusedIngest

            self.fused_ingest = FusedIngest(self.params)
            base_factory = factory

            def factory():  # noqa: F811 - deliberate seam wrapper
                drv = base_factory()
                if not hasattr(drv, "set_ingest_sink"):
                    # a custom factory handed us a driver without the
                    # ingest seam: surface ONE clear configuration error
                    # instead of an AttributeError crash-looping the FSM
                    # through RESETTING on every driver recreation
                    raise RuntimeError(
                        "ingest_backend='fused' requires a driver with "
                        "set_ingest_sink (wire-streaming RealLidarDriver); "
                        f"{type(drv).__name__} has none — use "
                        "ingest_backend='host' with this driver factory"
                    )
                # re-attach the one engine (and its rolling filter
                # window) to every recreated driver, like the chain
                # survives FSM resets on the host path
                drv.set_ingest_sink(self.fused_ingest)
                return drv

        self.fsm = ScanLoopFsm(
            factory,
            self._on_scan,
            params=self.params,
            timings=self._fsm_timings,
            on_state_change=self._on_fsm_state,
            on_filtered=self._on_filtered_output if fused else None,
        )
        if self.params.filter_chain and not fused:
            self.chain = ScanFilterChain(self.params)
            if self._chain_snapshot is not None:
                if not self.chain.restore(self._chain_snapshot):
                    # geometry changed since the snapshot: drop it rather
                    # than re-trying (and re-warning) every configure
                    self._chain_snapshot = None
        elif not fused:
            self.raw_device = pick_device(self.params.filter_backend)
            # raw publish path: warm it now, so the first live revolution
            # does not pay the first call's allocations
            self.precompile_publish_kernels()
        if self.params.map_enable and self.params.filter_chain:
            from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

            self.mapper = FleetMapper(self.params, 1)
            self.mapper.precompile()
            if self._mapper_snapshot is not None:
                if not self.mapper.restore(self._mapper_snapshot):
                    # geometry/schema changed since the snapshot: drop it
                    self._mapper_snapshot = None
            if self.params.loop_enable:
                from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine

                self.loop = LoopClosureEngine(self.params, self.mapper)
                self.loop.precompile()
                if self._loop_snapshot is not None:
                    if not self.loop.restore(self._loop_snapshot):
                        self._loop_snapshot = None
        self.diagnostics = DiagnosticsUpdater(
            hardware_id=f"rplidar-{self.params.serial_port}",
            publisher=self.publisher,
        )
        if self.params.publish_tf:
            self.publisher.publish_tf_static(
                StaticTransform(child=self.params.frame_id)
            )
        self._update_diagnostics()
        return True

    def precompile_publish_kernels(self) -> None:
        """Warm the RAW publish path — angle compensation and
        to_laserscan on ``raw_device`` — on a throwaway all-masked batch,
        both is_new_type variants.  Chain-path configs never reach it (the
        chain publishes its own output), so this runs only when the raw
        path is live.  Nothing compiles (the path is eager); the JAX
        package's node warms its jit cache here."""
        z = np.zeros((0,), np.int32)
        batch = apply_angle_compensation(
            ScanBatch.from_numpy(z, z, z, device=self.raw_device),
            self.params.angle_compensate,
        )
        for is_new in (False, True):
            to_laserscan(
                batch,
                0.1,
                40.0,
                scan_processing=self.params.scan_processing,
                inverted=self.params.inverted,
                is_new_type=is_new,
            )

    def on_activate(self) -> bool:
        assert self.fsm is not None
        self.fsm.start()
        self._update_diagnostics()
        return True

    def _on_fsm_state(self, state) -> None:
        # leaving RUNNING (deactivate, hot-unplug, RESETTING): drain the
        # pipelined publish seam NOW — the chain (and its pending output)
        # survives driver recreation, and an output held across a
        # recovery gap would otherwise be published arbitrarily late
        if state is not DriverState.RUNNING:
            self._drain_pipeline()
        self._update_diagnostics()

    def _drain_pipeline(self) -> None:
        """Publish the pipelined seam's in-flight revolution, if any.

        Must never raise: it runs inside the FSM loop's error handler,
        where an escaping exception would unwind the scan thread and kill
        recovery.  The pending output is dropped in that case."""
        if self.chain is None or self._pipeline_meta is None:
            return
        meta, self._pipeline_meta = self._pipeline_meta, None
        try:
            out = self.chain.flush_pipelined()
            if out is not None:
                self._publish_chain_output(out, *meta)
        except Exception:
            # the meta is spent, so the re-stashed output must go too
            self.chain.discard_pipelined()
            log.warning("dropping in-flight pipelined output (drain failed)",
                        exc_info=True)

    def on_deactivate(self) -> bool:
        if self.fsm:
            self.fsm.stop()
        # drain the pipelined publish seam: the last revolution's output
        # is still in flight when the scan thread stops
        self._drain_pipeline()
        # preserve the rolling window across deactivate/activate
        if self.chain is not None:
            self._chain_snapshot = self.chain.snapshot()
        if self.mapper is not None:
            self._mapper_snapshot = self.mapper.snapshot()
        if self.loop is not None:
            self._loop_snapshot = self.loop.snapshot()
        self._update_diagnostics()
        return True

    def on_cleanup(self) -> bool:
        self.fsm = None
        self.chain = None
        self.fused_ingest = None
        self.mapper = None
        self.loop = None
        self.raw_device = None
        # _chain_snapshot / _mapper_snapshot / _loop_snapshot intentionally
        # survive cleanup: they are the checkpoint/resume surface — a later
        # configure restores the rolling window, the map and the submap
        # library.  discard_checkpoint() drops them.
        return True

    def discard_checkpoint(self) -> None:
        """Forget the saved filter-window, map and loop snapshots (next
        configure starts cold)."""
        self._chain_snapshot = None
        self._mapper_snapshot = None
        self._loop_snapshot = None

    def save_checkpoint(self, path: str) -> bool:
        """Persist the filter-chain state — and, with the mapper, its
        MapState under versioned ``mapper.*`` keys, with the loop engine
        its LoopState under ``loop.*`` keys — to one atomic file
        (utils/checkpoint.py; the JAX package's format).

        Uses the live state when active/inactive, else the last
        deactivate-time snapshots.  Returns False when there is nothing to
        save (no chain configured and no snapshot held)."""
        from rplidar_ros2_driver_tpu_torch.utils.checkpoint import save_checkpoint

        snap = self.chain.snapshot() if self.chain is not None else self._chain_snapshot
        if snap is None:
            return False
        snap = dict(snap)
        mapper_snap = (
            self.mapper.snapshot() if self.mapper is not None else self._mapper_snapshot
        )
        if mapper_snap is not None:
            for k, v in mapper_snap.items():
                snap[_MAPPER_KEY_PREFIX + k] = v
        loop_snap = self.loop.snapshot() if self.loop is not None else self._loop_snapshot
        if loop_snap is not None:
            for k, v in loop_snap.items():
                snap[_LOOP_KEY_PREFIX + k] = v
        save_checkpoint(path, snap, extra={"node": self.name})
        return True

    def load_checkpoint(self, path: str) -> bool:
        """Stage an on-disk checkpoint for the next configure (or restore it
        immediately into an already-configured chain).

        Returns False — touching nothing — when the file is absent/torn
        or its geometry doesn't match the current chain parameters.  A
        checkpoint written by the JAX package loads here, its ``mapper.*``
        and ``loop.*`` keys included (restored when compatible; an
        incompatible map or library is dropped with the chain still
        restored — both are derived state)."""
        from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
        from rplidar_ros2_driver_tpu_torch.utils.checkpoint import load_checkpoint

        if not self.params.filter_chain:
            return False
        loaded = load_checkpoint(path)
        if loaded is None:
            return False
        snap, _meta = loaded
        mp, lp = _MAPPER_KEY_PREFIX, _LOOP_KEY_PREFIX
        mapper_snap = {k[len(mp):]: v for k, v in snap.items() if k.startswith(mp)} or None
        loop_snap = {k[len(lp):]: v for k, v in snap.items() if k.startswith(lp)} or None
        snap = {k: v for k, v in snap.items() if not k.startswith((mp, lp))}

        def stage_map_and_loop() -> None:
            if mapper_snap is not None:
                if self.mapper is not None:
                    if self.mapper.restore(mapper_snap):
                        self._mapper_snapshot = mapper_snap
                elif FleetMapper.snapshot_compatible(self.params, mapper_snap):
                    self._mapper_snapshot = mapper_snap
            if loop_snap is not None:
                if self.loop is not None:
                    if self.loop.restore(loop_snap):
                        self._loop_snapshot = loop_snap
                else:
                    # staged for the next configure, whose restore()
                    # validates schema and geometry
                    self._loop_snapshot = loop_snap

        if self.chain is not None:
            if not self.chain.restore(snap):  # rejects mismatch untouched
                return False
            self._chain_snapshot = snap
            stage_map_and_loop()
            return True
        # no live chain yet: validate host-side against the geometry the
        # next configure will build (no device transfers)
        if not ScanFilterChain.snapshot_compatible(self.params, snap):
            return False
        self._chain_snapshot = snap
        stage_map_and_loop()
        return True

    def on_shutdown(self) -> bool:
        return True

    # ------------------------------------------------------------------
    # hot path: one revolution
    # ------------------------------------------------------------------

    def _on_scan(self, scan: dict, start_time: float, duration: float) -> None:
        """One revolution, as raw host arrays (angle_q14/dist_q2/quality/
        flag numpy).  Chain path: one bit-packed upload + the step.  Raw
        path: ScanBatch upload + optional angle compensation +
        to_laserscan (publish_scan, src/rplidar_node.cpp:558-683)."""
        params = self.params
        max_range = self.fsm.cached_max_range or 40.0
        is_new = True
        if self.fsm.driver is not None:
            is_new = self.fsm.driver.is_new_type()

        with self.tracer.stage("filter"):
            out = None
            if self.chain is not None:
                if params.pipelined_publish:
                    # publish revolution N-1 while N computes (one
                    # revolution of declared staleness; the stamp below
                    # is N-1's own)
                    out = self.chain.process_raw_pipelined(
                        scan["angle_q14"], scan["dist_q2"], scan["quality"],
                        scan.get("flag"),
                    )
                    # max_range travels with the revolution too
                    meta, self._pipeline_meta = (
                        self._pipeline_meta, (start_time, duration, max_range)
                    )
                    if out is None or meta is None:
                        return  # first revolution of the stream: nothing pending
                    start_time, duration, max_range = meta
                else:
                    if self._pipeline_meta is not None:
                        # pipelined_publish was toggled off mid-stream:
                        # drain the in-flight revolution now, in order
                        self._drain_pipeline()
                    out = self.chain.process_raw(
                        scan["angle_q14"], scan["dist_q2"], scan["quality"],
                        scan.get("flag"),
                    )

        if out is not None:
            self._publish_chain_output(out, start_time, duration, max_range)
            return

        with self.tracer.stage("convert"):
            batch = apply_angle_compensation(
                ScanBatch.from_numpy(
                    scan["angle_q14"], scan["dist_q2"], scan["quality"],
                    scan.get("flag"), device=self.raw_device,
                ),
                params.angle_compensate,
            )
            ls = to_laserscan(
                batch,
                duration,
                max_range,
                scan_processing=params.scan_processing,
                inverted=params.inverted,
                is_new_type=is_new,
            )
            bc = int(ls.beam_count)
            if bc == 0:
                return
            msg = LaserScanHost(
                stamp=start_time,
                frame_id=params.frame_id,
                angle_min=float(ls.angle_min),
                angle_max=float(ls.angle_max),
                angle_increment=float(ls.angle_increment),
                time_increment=float(ls.time_increment),
                scan_time=float(ls.scan_time),
                range_min=float(ls.range_min),
                range_max=float(ls.range_max),
                ranges=ls.ranges[:bc].cpu().numpy(),
                intensities=ls.intensities[:bc].cpu().numpy(),
            )

        with self.tracer.stage("publish"):
            self.publisher.publish_scan(msg)

    def _on_filtered_output(self, out, ts0: float, duration: float) -> None:
        """Fused-ingest publish hook (FSM RUNNING loop): the revolution
        arrived decoded, assembled and filtered on the device — straight
        to the shared chain-output publisher."""
        with self.tracer.stage("filter"):
            pass  # device work already done inside the fused dispatch
        self._publish_chain_output(out, ts0, duration)

    def _publish_chain_output(
        self, out, stamp: float, duration: float, max_range: Optional[float] = None
    ) -> None:
        """Convert + publish one chain FilterOutput (shared by the
        synchronous path, the pipelined path, the deactivate-time
        pipeline drain and the fused-ingest hook).  The output is already
        on the fixed angular grid."""
        params = self.params
        if max_range is None:
            max_range = (self.fsm.cached_max_range if self.fsm else None) or 40.0
        with self.tracer.stage("convert"):
            beams = int(np.asarray(out.ranges).shape[0])
            msg = LaserScanHost(
                stamp=stamp,
                frame_id=params.frame_id,
                angle_min=0.0,
                angle_max=2.0 * np.pi,
                angle_increment=2.0 * np.pi / beams,
                time_increment=duration / beams,
                scan_time=duration,
                range_min=params.range_clip_min_m,
                range_max=max_range,
                ranges=np.asarray(out.ranges),
                intensities=np.asarray(out.intensities),
            )
        with self.tracer.stage("publish"):
            self.publisher.publish_scan(msg)
            self.publisher.publish_cloud(
                PointCloudHost(
                    stamp=stamp,
                    frame_id=params.frame_id,
                    points_xy=np.asarray(out.points_xy)[np.asarray(out.point_mask)],
                    voxel=np.asarray(out.voxel),
                )
            )
        if self.mapper is not None:
            with self.tracer.stage("map"):
                est = self.mapper.submit([out])[0]
                if self.loop is not None:
                    # submap finalization and, when due, one closure check;
                    # the pose published below is the corrected one
                    self.loop.observe([est])
            if est is not None:
                x_m, y_m, theta_rad = est.x_m, est.y_m, est.theta_rad
                if self.loop is not None:
                    x_m, y_m, theta_rad = pose_to_metric(
                        self.loop.corrected_pose_q(0, est.pose_q), self.mapper.cfg)
                self.publisher.publish_pose(PoseHost(
                    stamp=stamp,
                    frame_id="map",
                    child_frame_id=params.frame_id,
                    x_m=x_m,
                    y_m=y_m,
                    theta_rad=theta_rad,
                    score=est.score,
                    matched_points=est.matched_points,
                    map_revision=est.revision,
                ))

    # ------------------------------------------------------------------
    # diagnostics (src/rplidar_node.cpp:490-545)
    # ------------------------------------------------------------------

    def _update_diagnostics(self) -> None:
        if self.diagnostics is None:
            return
        lat = {}
        for stage in ("filter", "convert", "publish", "map"):
            p = self.tracer.percentile(stage, 99.0)
            if p > 0:
                lat[stage] = 1e3 * p
        driver = self.fsm.driver if self.fsm else None
        reconnect = None
        if self.fsm is not None and (
            self.fsm.connect_attempts or self.fsm.reconnect_backoff_s
        ):
            reconnect = {
                "attempts": self.fsm.connect_attempts,
                "backoff_s": self.fsm.reconnect_backoff_s,
            }
            drv_failures = getattr(driver, "connect_failures", None)
            if drv_failures:
                reconnect["driver_failures"] = drv_failures
        map_status = None
        if self.mapper is not None:
            est = self.mapper.last_estimates[0]
            map_status = {"backend": self.mapper.backend}
            if est is not None:
                map_status.update(
                    pose=(est.x_m, est.y_m, est.theta_rad),
                    score=est.score,
                    revision=est.revision,
                )
        self.diagnostics.update(
            lifecycle=self.lifecycle_state,
            fsm_state=self.fsm.state if self.fsm else None,
            port=self.params.serial_port,
            rpm=self.params.rpm,
            device_info=self.fsm.cached_device_info if self.fsm else "",
            latency_p99_ms=lat or None,
            rx_scheduling=driver.rx_scheduling_class() if driver is not None else None,
            map_status=map_status,
            loop_status=self.loop.status() if self.loop is not None else None,
            reconnect=reconnect,
        )

    # ------------------------------------------------------------------
    # dynamic reconfigure (src/rplidar_node.cpp:689-774)
    # ------------------------------------------------------------------

    def set_parameters(self, updates: dict) -> tuple[bool, str]:
        """Runtime parameter updates; returns (successful, reason)."""
        with self._param_lock:
            if self.fsm is None or self.fsm.driver is None:
                return False, "Driver not ready"
            with self.fsm.driver_mutex:
                if not self.fsm.driver.is_connected():
                    return False, "Driver not ready"
                for key, value in updates.items():
                    if key == "rpm":
                        if not isinstance(value, int) or not (0 <= value <= 1200):
                            return False, f"rpm {value} out of range [0, 1200]"
                        if not self.fsm.driver.set_motor_speed(value):
                            return False, "failed to apply motor speed"
                        self.params.rpm = value
                    elif key == "scan_processing":
                        self.params.scan_processing = bool(value)
                    elif key == "scan_mode":
                        ok = self._hot_swap_scan_mode(str(value))
                        if not ok:
                            return False, f"scan mode '{value}' rejected"
                    else:
                        return False, f"parameter '{key}' is not runtime-mutable"
            self._update_diagnostics()
            return True, "success"

    def _hot_swap_scan_mode(self, mode: str) -> bool:
        """stop motor -> 500 ms -> restart in new mode; fall back to auto
        on failure (src/rplidar_node.cpp:740-770)."""
        drv = self.fsm.driver
        drv.stop_motor()
        time.sleep(0.5 if self._fsm_timings is None else self._fsm_timings.idle_tick_s)
        if drv.start_motor(mode, self.params.rpm):
            self.params.scan_mode = mode
            return True
        log.error("scan mode '%s' failed; falling back to auto", mode)
        drv.start_motor("", self.params.rpm)
        self.params.scan_mode = ""
        return False


def make_node_from_yaml(path: str, **kwargs) -> RPlidarNode:
    """Launch-file equivalent: YAML is the single source of truth
    (launch/rplidar.launch.py:86-93)."""
    return RPlidarNode(DriverParams.from_yaml(path), **kwargs)


def launch(node: RPlidarNode) -> RPlidarNode:
    """Auto lifecycle bringup: CONFIGURE on start, ACTIVATE once inactive
    (launch/rplidar.launch.py:109-141)."""
    if node.lifecycle_state is LifecycleState.UNCONFIGURED:
        if not node.configure():
            return node
    if node.lifecycle_state is LifecycleState.INACTIVE:
        node.activate()
    return node
