"""Diagnostics updater.

Equivalent of the reference's diagnostic_updater wiring
(src/rplidar_node.cpp:206-208, 490-545): hardware id ``rplidar-<port>``,
a lifecycle-gated summary level and message, and key/value details (port,
target RPM, cached device info).
"""

from __future__ import annotations

from typing import Optional

from rplidar_ros2_driver_tpu_torch.node.fsm import DriverState
from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
from rplidar_ros2_driver_tpu_torch.node.messages import DiagLevel, DiagnosticStatus


def summarize(
    lifecycle: LifecycleState, fsm_state: Optional[DriverState]
) -> tuple[DiagLevel, str]:
    """Level/message table mirroring update_diagnostics
    (src/rplidar_node.cpp:497-520)."""
    if lifecycle is not LifecycleState.ACTIVE:
        return DiagLevel.OK, "Node Inactive (Lifecycle)"
    if fsm_state is DriverState.RUNNING:
        return DiagLevel.OK, "Scanning"
    if fsm_state is DriverState.WARMUP:
        return DiagLevel.WARN, "Warming Up"
    if fsm_state in (DriverState.CONNECTING, DriverState.CHECK_HEALTH):
        return DiagLevel.WARN, "Connecting"
    if fsm_state is DriverState.RESETTING:
        return DiagLevel.ERROR, "Resetting Hardware"
    return DiagLevel.WARN, "Unknown"


def rx_scheduling_label(code: int) -> str:
    """Human label for a driver rx_scheduling_class code — the ONE
    mapping, shared by /diagnostics and the doctor CLI."""
    return {
        2: "SCHED_RR",
        1: "nice boost",
        0: "default",
        -1: "no elevation",
    }.get(code, "n/a")


class DiagnosticsUpdater:
    def __init__(self, hardware_id: str, publisher) -> None:
        self.hardware_id = hardware_id
        self._publisher = publisher
        self.last: Optional[DiagnosticStatus] = None

    # graftlint: read-path
    def update(
        self,
        lifecycle: LifecycleState,
        fsm_state: Optional[DriverState],
        port: str,
        rpm: int,
        device_info: str,
        latency_p99_ms: Optional[dict[str, float]] = None,
        rx_scheduling: Optional[int] = None,
        map_status: Optional[dict] = None,
        loop_status: Optional[dict] = None,
        reconnect: Optional[dict] = None,
        stream_health: Optional[list] = None,
        shard_topology: Optional[dict] = None,
        scheduler: Optional[dict] = None,
        pod: Optional[dict] = None,
        world_map: Optional[dict] = None,
    ) -> DiagnosticStatus:
        level, message = summarize(lifecycle, fsm_state)
        values = {
            "Serial Port": port,
            "Target RPM": str(rpm),
            "Device Info": device_info,
            "FSM State": fsm_state.value if fsm_state else "n/a",
            "Lifecycle": lifecycle.value,
        }
        if rx_scheduling is not None:
            # the reference's PRIORITY_HIGH rx/decoder contract, observable
            values["RX Scheduling"] = rx_scheduling_label(rx_scheduling)
        # per-stage p99 latencies (utils/tracing.py) — the observability for
        # the <10 ms added-p99 publish-latency north star (BASELINE.md)
        if latency_p99_ms:
            for stage, ms in sorted(latency_p99_ms.items()):
                values[f"p99 {stage} (ms)"] = f"{ms:.3f}"
        # SLAM front-end observability (mapping/mapper.FleetMapper): the
        # matcher's pose/score/map-revision, mirroring how latencies ride
        # the same status message
        if map_status:
            values["Map Backend"] = str(map_status.get("backend", "?"))
            pose = map_status.get("pose")
            if pose is not None:
                x, y, th = pose
                values["Map Pose"] = f"{x:+.3f} {y:+.3f} {th:+.4f}"
                values["Map Match Score"] = str(map_status.get("score", 0))
                values["Map Revision"] = str(map_status.get("revision", 0))
        # SLAM back-end drift/loop-closure observability (slam/loop.
        # LoopClosureEngine.status()): accepted/rejected closures, the
        # per-stream submap library fill, the tick of the last accepted
        # closure, and the standing pose-correction magnitude — the
        # drift-bounded-or-not view at a glance (tests/test_loop_close.py
        # pins the rendering, like the shard-topology group)
        if loop_status:
            values["Loop Closures"] = (
                f"{loop_status.get('accepted', 0)} accepted / "
                f"{loop_status.get('rejected', 0)} rejected"
            )
            values["Loop Submaps"] = ",".join(
                str(c) for c in loop_status.get("submaps", [])
            )
            values["Loop Constraints"] = str(
                loop_status.get("constraints", 0)
            )
            last = loop_status.get("last_closure_tick")
            values["Last Closure Tick"] = (
                "n/a" if last is None else str(last)
            )
            corr = loop_status.get("correction_m")
            if corr is not None:
                cx, cy, cth = corr
                values["Pose Correction"] = (
                    f"{cx:+.3f} {cy:+.3f} {cth:+.4f}"
                )
        # reconnect observability (scan-loop FSM capped backoff +
        # driver-level connect counters): how hard the node is having to
        # fight for its link, and how long until the next attempt
        if reconnect:
            values["Connect Attempts"] = str(reconnect.get("attempts", 0))
            backoff = reconnect.get("backoff_s")
            if backoff:
                values["Reconnect Backoff (s)"] = f"{backoff:.2f}"
            drv_fail = reconnect.get("driver_failures")
            if drv_fail is not None:
                values["Driver Connect Failures"] = str(drv_fail)
        # per-stream health FSM states: FLEET deployments (which own a
        # ShardedFilterService rather than the single-stream node) feed
        # ``service.health_status()`` through this parameter — one
        # compact "state (reason)" value per stream
        # (tests/test_chaos.py pins the rendering)
        if stream_health:
            for i, st in enumerate(stream_health):
                state = st.get("state", "?")
                reason = st.get("reason") or ""
                values[f"Stream {i} Health"] = (
                    f"{state} ({reason})" if reason else state
                )
        # elastic-fleet shard topology + migration counters: pod
        # deployments (parallel/service.ElasticFleetService) feed
        # ``service.failover_status()`` through this parameter — one
        # compact "state [streams] (reason)" value per shard plus the
        # pod-level evacuation/migration counters
        # (tests/test_failover.py pins the rendering)
        if shard_topology:
            for i, sh in enumerate(shard_topology.get("shards", [])):
                state = sh.get("state", "?")
                hosted = ",".join(str(s) for s in sh.get("streams", []))
                reason = sh.get("reason") or ""
                val = f"{state} [{hosted}]"
                if reason:
                    val = f"{val} ({reason})"
                values[f"Shard {i}"] = val
            values["Evacuations"] = str(
                shard_topology.get("evacuations", 0)
            )
            values["Stream Migrations"] = str(
                shard_topology.get("migrations", 0)
            )
            values["Shard Readmissions"] = str(
                shard_topology.get("readmits", 0)
            )
            last = shard_topology.get("last_migration_tick")
            values["Last Migration Tick"] = (
                "n/a" if last is None else str(last)
            )
        # traffic-shaping scheduler (parallel/scheduler.TrafficShaper
        # via service.scheduler_status()): the current drain rung(s),
        # per-stream backlog depth + admission-shed counters (the
        # bounded-backlog contract at a glance), per-rung compiled-
        # dispatch accounting and the byte-rate placement weights —
        # mirroring the shard-topology group (tests/test_scheduler.py
        # pins the rendering)
        if scheduler:
            values["Sched Rung"] = ",".join(
                str(r) for r in scheduler.get("rungs", [])
            )
            values["Sched Backlog"] = ",".join(
                str(b) for b in scheduler.get("backlog", [])
            )
            values["Admission Drops"] = ",".join(
                str(d) for d in scheduler.get("admission_drops", [])
            )
            values["Admission Shed Total"] = str(
                scheduler.get("shed_total", 0)
            )
            rung_d = scheduler.get("rung_dispatches") or {}
            values["Rung Dispatches"] = " ".join(
                f"T{r}:{rung_d[r]}" for r in sorted(rung_d)
            ) or "n/a"
            weights = scheduler.get("weights")
            if weights is not None:
                values["Placement Weights"] = ",".join(
                    f"{w:.2f}" for w in weights
                )
            # link-latency hiding: the measured per-(rung,
            # bucket) cost table steering the deadline cap, the bucket
            # ladder's picks, and the double buffer's overlap hit
            # count — only rendered once the model has keys / the
            # ladder is configured (a plain rung-only shaper keeps the
            # rung-only group unchanged)
            model = scheduler.get("latency_model")
            if model:
                values["Latency Model ms"] = " ".join(
                    f"{k}:{model[k]}" for k in sorted(model)
                )
            buckets = scheduler.get("active_buckets")
            if buckets is not None:
                values["Active Bucket"] = ",".join(
                    str(b) for b in buckets
                )
                values["Bucket Switches"] = str(
                    scheduler.get("bucket_switches", 0)
                )
            hits = scheduler.get("staging_overlap_hits")
            if hits is not None:
                values["Staging Overlap Hits"] = str(hits)
        # pod-of-pods group (parallel/service.ElasticFleetService via
        # service.pod_status()): per-host shard states (PARKED marks a
        # shard the autoscaler spun down — engine released, membership
        # intact), the steal counters, the scale counters, and the
        # autoscaler's hysteresis state — mirroring the scheduler and
        # shard-topology groups (tests/test_scheduler.py pins the
        # rendering)
        if pod:
            for h in pod.get("per_host", []):
                states = " ".join(
                    f"{sh['shard']}:{sh['state']}[{sh['streams']}]"
                    for sh in h.get("shards", [])
                )
                values[f"Pod Host {h.get('host', '?')}"] = states or "n/a"
            values["Steals"] = str(pod.get("steals", 0))
            values["Steal Ticks"] = str(pod.get("steal_ticks", 0))
            values["Scale-Downs"] = str(pod.get("scale_downs", 0))
            values["Scale-Ups"] = str(pod.get("scale_ups", 0))
            auto = pod.get("autoscaler")
            if auto:
                occ = auto.get("occupancy")
                occ_s = "n/a" if occ is None else f"{occ:.3f}"
                values["Autoscaler"] = (
                    f"{auto.get('state', '?')} (occ {occ_s})"
                )
        if world_map:
            # the shared-world serving plane (mapping/worldmap.status())
            values["World Map"] = (
                f"{world_map.get('backend', '?')} "
                f"v{world_map.get('serving_version', 0)}"
            )
            values["World Tiles"] = str(world_map.get("tiles", 0))
            values["World Resident Bytes"] = str(
                world_map.get("resident_bytes", 0)
            )
            ratio = world_map.get("compression_ratio", 0.0)
            values["World Compression"] = f"{ratio:.2f}x"
            values["World Merges"] = str(world_map.get("merges", 0))
            values["World Evictions"] = str(
                world_map.get("evictions", 0)
            )
        status = DiagnosticStatus(
            level=level,
            name="rplidar_node: Device Status",
            message=message,
            hardware_id=self.hardware_id,
            values=values,
        )
        self.last = status
        self._publisher.publish_diagnostics(status)
        return status
