"""LoopClosureEngine — the SLAM back-end driver (``loop_backend`` seam).

The PyTorch counterpart of the JAX package's ``slam/loop.py``.  It attaches
beside a FleetMapper (the node's one stream, a replay, or a fleet of N
streams) and closes the loop on its trajectory:

  * SUBMAP LIFECYCLE — every ``loop_submap_revs`` revolutions a stream's
    map finalizes into a quantized submap plane + anchor pose
    (mapping/submap.py, one numpy path for both backends), installed into
    a per-stream library capped at ``loop_max_submaps`` (cap-and-hold).
  * CLOSURE CHECKS — every ``loop_check_revs`` revolutions the current
    scan is matched against the ``loop_candidates`` nearest submaps; an
    accepted match becomes a constraint and the pose graph is relaxed.
    All due streams of a tick go through ONE call of
    ops/loop_close.fleet_loop_close_step (``dispatch_count`` counts them):
    on the card one launch each of B6 and B7 for the whole fleet, then the
    gates and the solver.
  * CORRECTED POSES — each check's wire carries the corrected current
    pose; the engine keeps the correction delta per stream so later
    front-end estimates republish corrected (``corrected_pose_q``); with
    ``loop_reanchor`` the front-end pose itself is rewritten.

Backends:

  * ``host``  — the NumPy golden reference (ops/loop_close_ref.py), one
    step per due stream on the host.
  * ``fused`` — the device path: the stream-stacked :class:`LoopState` on
    the engine's device, updated in place; one host read of the wires (and
    the corrected anchors) a check.  A check's inputs go up from pinned
    buffers without blocking; every blocking transfer (that read, an
    install's uploads, the row pulls and restores) runs inside
    ``guards.declared_sync``, so a check holds the whole
    ``guards.steady_state``.  On a CPU device it runs the
    kernels' plain versions — bit-exact with the card and the host
    reference.
  * ``auto``  — ``fused`` on a CUDA device, ``host`` otherwise.  This is
    where the port differs from the JAX package, whose resolver keeps
    ``auto`` on ``host`` until an on-chip A/B clears its decision bar: the
    port's entry points run on the card unless the caller asks for the CPU
    (the precedent of mapping/mapper.resolve_map_backend).  Both arms are
    bit-exact, so the choice changes speed only.

The checkpoint surface mirrors FleetMapper's and keeps the JAX package's
format — numpy int32 arrays with a ``version`` key (LOOP_STATE_VERSION) —
so a snapshot of either package restores into the other byte for byte.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.mapping.submap import (
    check_due,
    eligible_candidates,
    finalize_due,
    quantize_submap_plane,
    select_candidates,
)
from rplidar_ros2_driver_tpu_torch.ops.loop_close import (
    LOOP_STATE_VERSION,
    STATE_KEYS,
    WIRE_LEN,
    LoopConfig,
    LoopState,
    derive_match_config,
)
from rplidar_ros2_driver_tpu_torch.ops.pose_graph import PoseGraphConfig
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, W_SCALE
from rplidar_ros2_driver_tpu_torch.utils import guards

log = logging.getLogger("rplidar_tpu.loop")


def resolve_loop_backend(requested: str, platform: Optional[str] = None) -> str:
    """``auto`` -> ``fused`` on a CUDA device, ``host`` otherwise; explicit
    requests pass through.  ``platform`` is the torch device type the
    engine would run on."""
    if requested != "auto":
        return requested
    return "fused" if platform == "cuda" else "host"


def loop_config_from_params(params, map_cfg, platform: Optional[str] = None) -> LoopConfig:
    """The one params -> LoopConfig mapping (the JAX package's), derived
    from the live mapper's MapConfig so library geometry and fixed-point
    scaling never drift from the front-end's.  ``platform`` (a torch device
    type) resolves the candidate matcher's ``match_backend``: ``auto`` is
    the kernels B6/B7 on a CUDA device."""
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import resolve_match_backend

    match = dataclasses.replace(
        derive_match_config(
            map_cfg,
            theta_window=int(params.loop_theta_window),
            window_cells=int(params.loop_window_cells),
        ),
        match_backend=resolve_match_backend(getattr(params, "match_backend", "auto"), platform),
    )
    k = int(params.loop_max_submaps)
    c = int(params.pose_graph_max_constraints)
    graph = PoseGraphConfig(
        max_nodes=k,
        max_constraints=k + c,
        iters=int(params.pose_graph_iters),
        theta_divisions=map_cfg.theta_divisions,
        t_limit_sub=map_cfg.t_limit_sub,
    )
    # the absolute gate's integer bar, derived from the stored-plane
    # ceiling; the min_quant_shift invariant keeps ceiling·W_SCALE·beams
    # below 2^31, so any shift >= 0 keeps the gate product in int32
    accept_q = max((match.clamp_q * W_SCALE) >> int(params.loop_accept_shift), 1)
    return LoopConfig(
        match=match,
        graph=graph,
        submap_revs=int(params.loop_submap_revs),
        max_submaps=k,
        check_revs=int(params.loop_check_revs),
        candidates=int(params.loop_candidates),
        max_constraints=c,
        min_points=int(params.loop_min_points),
        accept_q=accept_q,
        peak_shift=int(params.loop_peak_shift),
        weight=int(params.loop_weight),
        reanchor=bool(params.loop_reanchor),
    )


@dataclasses.dataclass(frozen=True)
class LoopStatus:
    """One stream's closure-check result (host numpy/ints)."""

    accepted: bool
    candidate: int           # matched submap slot (-1 = none scored)
    score: int               # best candidate score (raw integer)
    matched_points: int
    corrected_q: np.ndarray  # (3,) int32 pose-graph-corrected current pose
    correction_q: np.ndarray  # (3,) int32 corrected - front-end (θ wrapped)
    constraints: int         # loop constraints in the graph after this check
    dropped: int             # accepts dropped at the constraint cap


class LoopClosureEngine:
    """Per-stream submap library + closure detection + pose-graph
    correction driver.  Every state access serializes on one lock (the
    fused check updates the state in place).  ``dispatch_count`` counts
    the fused check calls (one per tick with a due stream), ``checks`` the
    stream checks and ``installs`` the submap installs, so a run can show
    one call per check tick."""

    def __init__(self, params, mapper) -> None:
        from rplidar_ros2_driver_tpu_torch.filters.chain import pick_device

        self.mapper = mapper
        self.streams = mapper.streams
        requested = getattr(params, "loop_backend", "auto")
        dev = None
        if requested != "host":
            # the mapper's device, else the card unless filter_backend says
            # cpu (pick_device raises without one)
            dev = getattr(mapper, "device", None)
            dev = torch.device(dev) if dev is not None else pick_device(params.filter_backend)
        self.backend = resolve_loop_backend(requested, dev.type if dev is not None else None)
        if self.backend not in ("host", "fused"):
            raise ValueError(
                f"loop_backend must resolve to 'host' or 'fused', got {self.backend!r}"
            )
        self.device = dev if self.backend == "fused" else None
        self.cfg = loop_config_from_params(
            params, mapper.cfg, self.device.type if self.device is not None else None)
        self._lock = threading.Lock()
        self._states: Optional[LoopState] = None  # fused: device state
        self._states_np: Optional[dict] = None    # host: stacked numpy arrays
        self._staging: dict = {}                   # fused on a card: pinned inputs
        s, k = self.streams, self.cfg.max_submaps
        # host mirrors of the selection inputs, kept identically by both
        # backends (finalize is host-side), so candidate selection is ONE
        # code path
        self._anchors = np.zeros((s, k, 3), np.int32)
        self._valid = np.zeros((s, k), np.int32)
        self._count = np.zeros((s,), np.int32)
        self._corr = np.zeros((s, 3), np.int32)   # world-frame delta
        self._ncons = np.zeros((s,), np.int32)    # host ncons mirror
        self._last_final_rev = np.zeros((s,), np.int64)
        self._last_check_rev = np.zeros((s,), np.int64)
        # world-map tap: called as on_install(stream, plane, anchor) after
        # every submap finalization, with the exact quantized plane the
        # library stored
        self.on_install: Optional[Callable] = None
        self.reset_counters()
        self._install_state(self._fresh_states())

    # -- state construction -------------------------------------------------

    def reset_counters(self) -> None:
        s = self.streams
        self.ticks = 0
        self.checks = 0
        self.installs = 0
        self.dispatch_count = 0
        self.closures_accepted = np.zeros((s,), np.int64)
        self.closures_rejected = np.zeros((s,), np.int64)
        self.last_closure_tick: list[Optional[int]] = [None] * s
        self.last_status: list[Optional[LoopStatus]] = [None] * s

    def _fresh_states(self) -> dict:
        return {k: np.zeros((self.streams,) + v, np.int32)
                for k, v in LoopState.shapes(self.cfg).items()}

    def _install_state(self, stacked_np: dict) -> None:
        with self._lock:
            if self.backend == "fused":
                with guards.declared_sync():  # the state's upload
                    self._states = LoopState.from_numpy(stacked_np, self.device)
            else:
                self._states_np = {k: np.asarray(stacked_np[k], np.int32).copy()
                                   for k in STATE_KEYS}
        self._anchors = np.asarray(stacked_np["anchors"], np.int32).copy()
        self._valid = np.asarray(stacked_np["valid"], np.int32).copy()
        self._count = np.asarray(stacked_np["count"], np.int32).copy()
        self._ncons = np.asarray(stacked_np["ncons"], np.int32).reshape(-1).copy()
        # a standing correction belongs to the REPLACED constraint set, and
        # the cadence dedupe markers to the replaced revision stream
        self._corr[:] = 0
        self._last_final_rev[:] = 0
        self._last_check_rev[:] = 0

    def precompile(self) -> None:
        """One check and one install on a throwaway state: on the card this
        builds and loads the matcher kernels at the loop's shapes and warms
        the allocator, so the first live check does not pay for them.  With
        ``reanchor``, the mapper's re-anchor row op too (a no-op rewrite).
        No-op on the host backend."""
        if self.backend != "fused":
            return
        from rplidar_ros2_driver_tpu_torch.ops.loop_close import (
            fleet_install_submap,
            fleet_loop_close_step,
        )

        cfg, dev = self.cfg, self.device
        s, kc, b, g = self.streams, cfg.candidates, cfg.match.beams, cfg.match.grid
        throwaway = LoopState.create(cfg, s, dev)
        fleet_install_submap(throwaway, 0, torch.zeros((g, g), dtype=torch.int32, device=dev),
                             torch.zeros((3,), dtype=torch.int32, device=dev), cfg)
        fleet_loop_close_step(
            throwaway, torch.zeros((s, b, 2), dtype=torch.float32, device=dev),
            torch.zeros((s, b), dtype=torch.bool, device=dev),
            torch.zeros((s, 3), dtype=torch.int32, device=dev),
            torch.full((s, kc), -1, dtype=torch.int32, device=dev),
            torch.zeros((s,), dtype=torch.int32, device=dev), cfg)
        if dev.type == "cuda":
            # the check's pinned input buffers, at the shapes observe() stages
            for name, shape, dtype in (("points", (s, b, 2), np.float32),
                                       ("masks", (s, b), bool), ("poses", (s, 3), np.int32),
                                       ("cand_idx", (s, kc), np.int32),
                                       ("check", (s,), np.int32)):
                self._upload(name, np.zeros(shape, dtype), dtype)
            torch.cuda.synchronize(dev)
        if cfg.reanchor:
            snap = self.mapper.snapshot_stream(0)
            self.mapper.reanchor_stream(0, snap["pose"])

    # -- submap lifecycle ---------------------------------------------------

    def _install_submap(self, i: int, plane: np.ndarray, anchor: np.ndarray) -> None:
        if self.backend == "fused":
            from rplidar_ros2_driver_tpu_torch.ops.loop_close import fleet_install_submap

            dev = self.device
            with self._lock:
                with guards.declared_sync():  # the plane's and the anchor's uploads
                    plane_t = torch.from_numpy(np.asarray(plane, np.int32)).to(dev)
                    anchor_t = torch.from_numpy(np.asarray(anchor, np.int32).copy()).to(dev)
                fleet_install_submap(self._states, i, plane_t, anchor_t, self.cfg)
        else:
            from rplidar_ros2_driver_tpu_torch.ops.loop_close_ref import install_submap_np

            with self._lock:
                st = self._states_np
                new = install_submap_np({k: st[k][i] for k in STATE_KEYS}, plane, anchor,
                                        self.cfg)
                for k in STATE_KEYS:
                    st[k][i] = new[k]
        # host mirrors (identical for both backends: cap-and-hold)
        c = int(self._count[i])
        if c < self.cfg.max_submaps:
            self._anchors[i, c] = np.asarray(anchor, np.int32)
            self._valid[i, c] = 1
            self._count[i] = c + 1
            self.installs += 1
            if self.on_install is not None:
                self.on_install(i, plane, anchor)

    # -- hot path -----------------------------------------------------------

    def observe(self, estimates: Sequence) -> list[Optional[LoopStatus]]:
        """One fleet tick, called right after the mapper's submit with its
        per-stream estimates: runs due submap finalizations, then — when any
        stream's check is due — ONE batched check.  Returns one
        Optional[LoopStatus] per stream (None = no check ran this tick)."""
        if len(estimates) != self.streams:
            raise ValueError(f"expected {self.streams} estimates, got {len(estimates)}")
        if self.mapper.last_inputs is None:
            raise RuntimeError(
                "loop engine observed before any mapper tick (the check "
                "matches the mapper's CURRENT scan window)"
            )
        self.ticks += 1
        cfg = self.cfg
        points, masks, live = self.mapper.last_inputs

        # -- finalize due submaps (host-side quantize, one path) ------------
        for i, est in enumerate(estimates):
            if est is None or not live[i]:
                continue
            rev = int(est.revision)
            if (finalize_due(rev, cfg) and self._last_final_rev[i] != rev
                    and int(self._count[i]) < cfg.max_submaps):
                snap = self.mapper.snapshot_stream(i)
                plane = quantize_submap_plane(snap["log_odds"], self.mapper.cfg)
                self._install_submap(i, plane, snap["pose"])
                self._last_final_rev[i] = rev

        # -- closure checks -------------------------------------------------
        check = np.zeros((self.streams,), np.int32)
        cand_idx = np.full((self.streams, cfg.candidates), -1, np.int32)
        poses = np.zeros((self.streams, 3), np.int32)
        for i, est in enumerate(estimates):
            if est is None or not live[i]:
                continue
            poses[i] = est.pose_q
            rev = int(est.revision)
            if (check_due(rev, cfg) and self._last_check_rev[i] != rev
                    and eligible_candidates(self._valid[i], int(self._count[i]), cfg).any()):
                check[i] = 1
                cand_idx[i] = select_candidates(self._anchors[i], self._valid[i],
                                                int(self._count[i]), est.pose_q, cfg)
                self._last_check_rev[i] = rev
        statuses: list[Optional[LoopStatus]] = [None] * self.streams
        if not check.any():
            self.last_status = statuses
            return statuses

        wires, corrected = self._dispatch_check(points, masks, poses, cand_idx, check)
        self.checks += int(check.sum())

        div = cfg.match.theta_divisions
        half = div // 2
        for i in range(self.streams):
            if not check[i]:
                continue
            w = wires[i]
            accepted = bool(w[0])
            cur_c = w[4:7].astype(np.int32)
            dth = int(np.mod(int(cur_c[2]) - int(poses[i][2]) + half, div)) - half
            corr = np.asarray([int(cur_c[0]) - int(poses[i][0]),
                               int(cur_c[1]) - int(poses[i][1]), dth], np.int32)
            self._corr[i] = corr
            self._ncons[i] = int(w[7])
            st = LoopStatus(
                accepted=accepted, candidate=int(w[1]), score=int(w[2]),
                matched_points=int(w[3]), corrected_q=cur_c, correction_q=corr,
                constraints=int(w[7]), dropped=int(w[8]),
            )
            statuses[i] = st
            self.last_status[i] = st
            if accepted:
                self.closures_accepted[i] += 1
                self.last_closure_tick[i] = self.ticks
                if cfg.reanchor:
                    self.mapper.reanchor_stream(i, cur_c)
                    self._anchors[i] = corrected[i]
                    # the front-end now IS the corrected frame: the stored
                    # correction would double-apply
                    self._corr[i] = 0
            else:
                self.closures_rejected[i] += 1
        self.last_status = statuses
        return statuses

    def _upload(self, name: str, a, dtype) -> torch.Tensor:
        """One check input on the engine's device.  On a card it is copied
        into a pinned host buffer kept for that input and uploaded without
        blocking; the buffer is rewritten only at the next check, after this
        check's result fetch has waited for the copy."""
        host = torch.from_numpy(np.ascontiguousarray(a, dtype))
        if self.device.type != "cuda":
            return host.to(self.device)
        buf = self._staging.get(name)
        if buf is None or buf.shape != host.shape:
            buf = self._staging[name] = torch.empty_like(host, pin_memory=True)
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True)

    def _dispatch_check(self, points, masks, poses, cand_idx, check):
        """One batched check (fused) or one host step per due stream;
        returns host (S, WIRE_LEN) wires + (S, K, 3) corrected anchors."""
        s, k = self.streams, self.cfg.max_submaps
        with self._lock:
            if self.backend == "fused":
                from rplidar_ros2_driver_tpu_torch.ops.loop_close import fleet_loop_close_step

                inputs = (self._upload("points", points, np.float32),
                          self._upload("masks", masks, bool),
                          self._upload("poses", poses, np.int32),
                          self._upload("cand_idx", cand_idx, np.int32),
                          self._upload("check", check, np.int32))
                _, wires, corrected = fleet_loop_close_step(self._states, *inputs, self.cfg)
                self.dispatch_count += 1
                # one device->host copy a check: the wires and the anchors
                with guards.declared_sync():
                    host = torch.cat([wires, corrected.reshape(s, k * 3)],
                                     dim=1).cpu().numpy()
                return host[:, :WIRE_LEN], host[:, WIRE_LEN:].reshape(s, k, 3)
            from rplidar_ros2_driver_tpu_torch.ops.loop_close_ref import loop_close_step_np

            st = self._states_np
            wires = np.zeros((s, WIRE_LEN), np.int32)
            corrected = np.zeros((s, k, 3), np.int32)
            for i in range(s):
                if not check[i]:
                    # a non-due stream passes through: skipping it is
                    # bit-identical (observe() ignores its wire)
                    continue
                new, wires[i], corrected[i] = loop_close_step_np(
                    {key: st[key][i] for key in STATE_KEYS}, points[i], masks[i], poses[i],
                    cand_idx[i], int(check[i]), self.cfg)
                for key in STATE_KEYS:
                    st[key][i] = new[key]
            return wires, corrected

    # -- corrected-pose surface --------------------------------------------

    def corrected_pose_q(self, i: int, pose_q) -> np.ndarray:
        """Stream ``i``'s standing pose-graph correction applied to a
        front-end pose — the corrected pose published between checks."""
        p = np.asarray(pose_q, np.int64)
        d = self._corr[i].astype(np.int64)
        lim = self.cfg.match.t_limit_sub
        div = self.cfg.match.theta_divisions
        return np.asarray([np.clip(p[0] + d[0], -lim, lim), np.clip(p[1] + d[1], -lim, lim),
                           np.mod(p[2] + d[2], div)], np.int32)

    def status(self) -> dict:
        """Aggregate snapshot for /diagnostics (node/diagnostics.py
        ``loop_status``)."""
        ticks = [t for t in self.last_closure_tick if t is not None]
        cell = self.mapper.cfg.cell_m
        corr = self._corr.astype(np.float64)
        mags = np.abs(corr[:, 0]) + np.abs(corr[:, 1])
        worst = int(np.argmax(mags)) if len(mags) else 0
        return {
            "backend": self.backend,
            "submaps": [int(c) for c in self._count],
            "accepted": int(self.closures_accepted.sum()),
            "rejected": int(self.closures_rejected.sum()),
            "constraints": int(self._ncons.sum()),
            "last_closure_tick": max(ticks) if ticks else None,
            "checks": self.checks,
            "correction_m": (
                float(corr[worst, 0]) * (cell / SUB),
                float(corr[worst, 1]) * (cell / SUB),
                float(corr[worst, 2]) * (2.0 * np.pi / self.cfg.match.theta_divisions),
            ),
        }

    # -- checkpoint surface (the JAX package's format) ----------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Host copy of every stream's LoopState plus the schema
        ``version`` key; the same format on both backends and in both
        packages."""
        with self._lock:
            if self.backend == "fused":
                with guards.declared_sync():
                    snap = self._states.to_numpy()
            else:
                snap = {k: v.copy() for k, v in self._states_np.items()}
        snap["version"] = np.asarray(LOOP_STATE_VERSION, np.int32)
        return snap

    def _shape_mismatch(self, snap: dict, streams: int):
        expected = {k: (streams, *v) for k, v in LoopState.shapes(self.cfg).items()}
        got = {k: tuple(np.asarray(v).shape) for k, v in snap.items() if k != "version"}
        return None if expected == got else (got, expected)

    def restore(self, snap: Optional[dict]) -> bool:
        """Restore a snapshot (either package's), or cold-reset when None.
        A version or geometry mismatch is rejected with the live state
        untouched (returns False)."""
        if snap is None:
            self._install_state(self._fresh_states())
            return False
        if int(np.asarray(snap.get("version", -1))) != LOOP_STATE_VERSION:
            log.warning("rejecting loop snapshot with schema version %s (want %d)",
                        snap.get("version"), LOOP_STATE_VERSION)
            return False
        if self._shape_mismatch(snap, self.streams) is not None:
            log.warning("rejecting incompatible loop snapshot")
            return False
        self._install_state({k: np.asarray(snap[k]) for k in STATE_KEYS})
        return True

    def _check_stream(self, i: int) -> None:
        if not (0 <= i < self.streams):
            raise IndexError(f"stream {i} out of range [0, {self.streams})")

    def snapshot_stream(self, i: int) -> dict:
        """One stream's LoopState row, schema-versioned (the per-stream
        migration unit beside the mapper's row)."""
        self._check_stream(i)
        with self._lock:
            if self.backend == "fused":
                with guards.declared_sync():  # the row's copy to the host
                    snap = {k: getattr(self._states, k)[i].cpu().numpy().copy()
                            for k in STATE_KEYS}
            else:
                snap = {k: self._states_np[k][i].copy() for k in STATE_KEYS}
        snap["version"] = np.asarray(LOOP_STATE_VERSION, np.int32)
        return snap

    def restore_stream(self, i: int, snap: dict) -> bool:
        """Install a :meth:`snapshot_stream` row into stream ``i``, every
        other stream untouched (a version or geometry mismatch is rejected
        with the live state untouched); the host mirrors resync from the
        restored row."""
        self._check_stream(i)
        if int(np.asarray(snap.get("version", -1))) != LOOP_STATE_VERSION:
            log.warning("rejecting stream loop snapshot with schema version %s (want %d)",
                        snap.get("version"), LOOP_STATE_VERSION)
            return False
        expected = LoopState.shapes(self.cfg)
        got = {k: tuple(np.asarray(v).shape) for k, v in snap.items() if k != "version"}
        if expected != got:
            log.warning("rejecting incompatible stream loop snapshot (%s != %s)", got, expected)
            return False
        with self._lock:
            for k in STATE_KEYS:
                row = np.asarray(snap[k], np.int32)
                if self.backend == "fused":
                    with guards.declared_sync():  # the row's upload
                        getattr(self._states, k)[i].copy_(torch.from_numpy(row.copy()))
                else:
                    self._states_np[k][i] = row
        self._anchors[i] = np.asarray(snap["anchors"], np.int32)
        self._valid[i] = np.asarray(snap["valid"], np.int32)
        self._count[i] = int(np.asarray(snap["count"]))
        self._ncons[i] = int(np.asarray(snap["ncons"]))
        self._corr[i] = 0
        # the cadence markers tracked the previous occupant's revisions
        self._last_final_rev[i] = 0
        self._last_check_rev[i] = 0
        return True
