"""Record / replay: capture raw wire frames, batch-decode them on the card,
run the revolutions through the fused K-scan filter chain and, with
:func:`replay_with_map`, through the SLAM front-end mapper (with
:func:`replay_with_loop_closure`, the back-end too); or, with
:func:`replay_raw_fused`, run the raw bytes through the fused device ingest;
or, with :func:`replay_fleet`, run several captures side by side through
the sharded fleet scan.

The PyTorch counterpart of the JAX package's ``replay.py`` (its recorder,
reader, batched decode, ``replay_through_chain``, ``replay_fleet``,
``replay_with_map``, ``replay_with_loop_closure`` and
``replay_raw_fused``): a capture decodes as
a handful of ``(M, frame_bytes)`` batch decodes (ops/unpack.py) on the
chosen device instead of a per-byte loop; the revolution split stays numpy
on the host; then the revolutions advance the rolling window ``chunk``
scans per call of ops/filters.compact_filter_scan.  Every entry point runs
on ``cuda:0`` unless the caller passes a CPU device, and raises without a
card — never a silent fall back to the host.

File format (little-endian), append-only and tail-truncation safe — the
JAX package's, byte for byte:

    magic  b"RPLR" | u16 version | u16 reserved
    record u8 ans_type | u8 pad | u16 payload_len | f64 ts | payload
"""

from __future__ import annotations

import dataclasses
import io
import math
import struct
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.ops import unpack
from rplidar_ros2_driver_tpu_torch.protocol.constants import ANS_PAYLOAD_BYTES, Ans

MAGIC = b"RPLR"
VERSION = 1
_HEADER = struct.Struct("<4sHH")
_REC = struct.Struct("<BBHd")


class FrameRecorder:
    """Appends measurement frames to a capture file (thread-safe enough for
    the single decode thread that feeds it)."""

    def __init__(self, path: str) -> None:
        self._f: Optional[io.BufferedWriter] = open(path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0))
        self.frames = 0
        # serializes write vs close: a close racing the decode thread
        # mid-write must not abort the live decode of that frame
        self._lock = threading.Lock()

    def write(self, ans_type: int, payload: bytes, ts: float = 0.0) -> None:
        with self._lock:
            f = self._f
            if f is None:
                return  # closed concurrently: drop silently
            f.write(_REC.pack(ans_type & 0xFF, 0, len(payload), ts))
            f.write(payload)
            self.frames += 1

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "FrameRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_frames(path: str) -> Iterator[tuple[int, float, bytes]]:
    """Yield (ans_type, ts, payload); stops cleanly at a truncated tail."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            return
        magic, version, _ = _HEADER.unpack(head)
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"{path}: not a frame recording (or wrong version)")
        while True:
            rec = f.read(_REC.size)
            if len(rec) < _REC.size:
                return
            ans_type, _, length, ts = _REC.unpack(rec)
            payload = f.read(length)
            if len(payload) < length:
                return  # torn tail: crash mid-write
            yield ans_type, ts, payload


def _device(device) -> torch.device:
    """The replay's device: ``None`` means the card (``cuda:0``, raising
    without one); anything else is taken as given."""
    if device is None:
        from rplidar_ros2_driver_tpu_torch.filters.chain import pick_device

        return pick_device("cuda")
    return torch.device(device)


# -- batched decode ----------------------------------------------------------

# ans_type -> batch decoder
_BATCH_KERNELS = {
    int(Ans.MEASUREMENT): unpack.unpack_normal_nodes,
    int(Ans.MEASUREMENT_CAPSULED): unpack.unpack_capsules,
    int(Ans.MEASUREMENT_CAPSULED_ULTRA): unpack.unpack_ultra_capsules,
    int(Ans.MEASUREMENT_DENSE_CAPSULED): unpack.unpack_dense_capsules,
    int(Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED): unpack.unpack_ultra_dense_capsules,
    int(Ans.MEASUREMENT_HQ): unpack.unpack_hq_capsules,
}


@dataclasses.dataclass
class DecodedRecording:
    """Flat, time-ordered node stream (numpy) + per-run stats."""

    angle_q14: np.ndarray
    dist_q2: np.ndarray
    quality: np.ndarray
    flag: np.ndarray
    runs: list  # [(ans_type, n_frames, n_valid_nodes)]

    @property
    def num_nodes(self) -> int:
        return int(self.angle_q14.shape[0])

    def revolutions(self) -> list[dict[str, np.ndarray]]:
        """Split the node stream at sync flags into complete revolutions
        (partial leading/trailing data dropped, like the live assembler)."""
        sync = np.flatnonzero(self.flag & 1)
        return [
            {
                "angle_q14": self.angle_q14[a:b],
                "dist_q2": self.dist_q2[a:b],
                "quality": self.quality[a:b],
                "flag": self.flag[a:b],
            }
            for a, b in zip(sync[:-1], sync[1:])
        ]


def decode_recording(path: str, device=None) -> DecodedRecording:
    """Batch-decode a capture: consecutive same-type frames become ONE
    decode over a (M, frame_bytes) uint8 tensor on ``device`` (default the
    card); the valid nodes come back to the host as one numpy stream."""
    dev = _device(device)
    runs: list[tuple[int, list[bytes]]] = []
    for ans_type, _ts, payload in read_frames(path):
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        if expect is None or len(payload) != expect:
            continue  # non-measurement or malformed record
        if runs and runs[-1][0] == ans_type:
            runs[-1][1].append(payload)
        else:
            runs.append((ans_type, [payload]))

    keys = ("angle_q14", "dist_q2", "quality", "flag")
    parts = {k: [] for k in keys}
    stats = []
    for ans_type, frames in runs:
        arr = np.frombuffer(b"".join(frames), np.uint8).reshape(len(frames), -1)
        dec = _BATCH_KERNELS[ans_type](torch.from_numpy(arr.copy()).to(dev))
        valid = dec.node_valid.reshape(-1)
        # one device->host copy per run: the four fields' valid nodes
        nodes = torch.stack([getattr(dec, k).reshape(-1)[valid] for k in keys]).cpu().numpy()
        for key, row in zip(keys, nodes):
            parts[key].append(row)
        stats.append((ans_type, len(frames), int(nodes.shape[1])))

    cat = {
        k: (np.concatenate(v).astype(np.int32) if v else np.zeros(0, np.int32))
        for k, v in parts.items()
    }
    return DecodedRecording(runs=stats, **cat)


def replay_through_chain(
    revolutions: list[dict],
    params,
    *,
    beams: int | None = None,
    capacity: int = 4096,
    chunk: int = 256,
):
    """Batch-process decoded revolutions through the filter chain with the
    fused multi-scan step (ops/filters.compact_filter_scan): the whole
    capture advances the rolling window in ``len(revs)/chunk`` calls
    instead of one per scan — the offline twin of the streaming
    ScanFilterChain (identical state trajectory).  The device is
    ``params.filter_backend``'s (filters/chain.pick_device: the card
    unless it says ``cpu``).

    Returns (per-scan (K, beams) float32 median range images, final
    FilterState copied to the host — whose ``voxel_acc`` is the window
    accumulation after the last scan)."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import (
        DEFAULT_BEAMS,
        config_from_params,
        pick_device,
    )
    from rplidar_ros2_driver_tpu_torch.ops.filters import (
        FilterState,
        compact_filter_scan,
        pack_host_scans_compact,
    )

    device = pick_device(params.filter_backend)
    cfg = config_from_params(params, beams or DEFAULT_BEAMS, platform=device.type)
    state = FilterState.for_config(cfg, device=device)
    outs = []
    for i in range(0, len(revolutions), chunk):
        seq, counts = pack_host_scans_compact(revolutions[i : i + chunk], capacity)
        state, ranges = compact_filter_scan(
            state,
            torch.from_numpy(seq.view(np.int16)).to(device),
            torch.from_numpy(counts).to(device),
            cfg,
        )
        outs.append(ranges)
    # one device->host copy at the end: no per-chunk synchronisation
    ranges = (
        torch.cat(outs).cpu().numpy() if outs else np.zeros((0, cfg.beams), np.float32)
    )
    return ranges, state.to(torch.device("cpu"))


def replay_fleet(
    stream_revolutions: list[list[dict]],
    params,
    *,
    mesh=None,
    beams: int | None = None,
    capacity: int = 4096,
    chunk: int = 256,
):
    """Fleet-scale :func:`replay_through_chain`: N streams' captures
    through the fused K-scan chain over a ``(stream, beam)`` mesh
    (parallel/sharding.build_sharded_scan): per chunk ONE sliding-median
    launch (B3 on the card) for the whole fleet's history stripes and one
    voxel all-reduce, instead of one per scan.

    Streams are truncated to the shortest capture (a chunk is one
    rectangular (S, K, 3, N) sequence).  The default mesh is the JAX
    package's: over the visible cards, the largest card count whose
    ``(stream, beam)`` split divides both the fleet size and ``beams``
    (:func:`fleet_mesh_split`), held in this process; ``(1, 1)`` on the
    host when ``params.filter_backend`` says ``cpu``, and on this process's
    card inside a process group.  On a mesh that spans
    processes the results are this process's block.  Returns ((S, K,
    beams) float32 range images, final FilterState copied to the host); an
    empty fleet returns ((0, 0, beams), None) without touching a device."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import (
        DEFAULT_BEAMS,
        config_from_params,
        pick_device,
    )
    from rplidar_ros2_driver_tpu_torch.ops.filters import pack_host_scans_compact
    from rplidar_ros2_driver_tpu_torch.parallel.sharding import (
        build_sharded_scan,
        create_sharded_state,
        gather_state,
        make_mesh,
    )

    streams = len(stream_revolutions)
    if streams == 0:
        return np.zeros((0, 0, beams or DEFAULT_BEAMS), np.float32), None
    if mesh is None:
        dev = pick_device(params.filter_backend)
        if dev.type == "cpu" or torch.distributed.is_initialized():
            mesh = make_mesh(n_devices=1, device=dev)
        else:
            n, stream = fleet_mesh_split(streams, beams or DEFAULT_BEAMS,
                                         torch.cuda.device_count())
            mesh = make_mesh(n_devices=n, stream=stream)
    cfg = config_from_params(params, beams or DEFAULT_BEAMS, platform=mesh.device.type)
    k_total = min(len(r) for r in stream_revolutions)
    local = mesh.local_streams(streams)
    scan_fn = build_sharded_scan(mesh, cfg)
    state = create_sharded_state(mesh, cfg, streams)
    outs = []
    for i in range(0, k_total, chunk):
        hi = min(i + chunk, k_total)
        seqs, counts = zip(*[
            pack_host_scans_compact(revs[i:hi], capacity)
            for revs in stream_revolutions[local]
        ])
        state, ranges = scan_fn(state, np.stack(seqs), np.stack(counts).astype(np.int32))
        outs.append(ranges)
    # one device->host copy at the end: no per-chunk synchronisation
    ranges = (
        torch.cat(outs, dim=1).cpu().numpy() if outs
        else np.zeros((local.stop - local.start, 0, cfg.beams), np.float32)
    )
    if mesh.multi_block:
        from rplidar_ros2_driver_tpu_torch.ops.filters import FilterState

        whole = {k: torch.from_numpy(v) for k, v in gather_state(mesh, state).items()}
        return ranges, FilterState(**{f.name: whole.get(f.name)
                                      for f in dataclasses.fields(FilterState)})
    return ranges, state.to(torch.device("cpu"))


def fleet_mesh_split(streams: int, beams: int, devices: int) -> tuple[int, int]:
    """(devices used, stream extent) of :func:`replay_fleet`'s default
    mesh, the JAX package's rule: the largest device count ``n`` for which
    some stream extent divides ``gcd(streams, n)`` and leaves a beam extent
    ``n // stream`` that divides ``beams`` (the largest such stream
    extent); ``(1, 1)`` always qualifies."""
    for n in range(devices, 0, -1):
        g = math.gcd(streams, n)
        ok = [d for d in range(g, 0, -1) if g % d == 0 and beams % (n // d) == 0]
        if ok:
            return n, ok[0]
    return 1, 1


def _replay_map_core(
    revolutions: list[dict],
    params,
    *,
    beams: int | None,
    capacity: int,
    chunk: int,
    with_loop: bool,
):
    """The offline SLAM replay loop both map entry points share: chain
    replay, then the numpy beam-grid projection of each median range image
    on the host (float32 θ, numpy cos/sin, float32 products — the JAX
    package's lines verbatim, so both packages feed the mapper the same
    float32 points bit for bit), then one mapper tick per scan and — with
    ``with_loop`` — a loop-closure engine observing every tick, the
    corrected trajectory recorded next to the raw one."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import DEFAULT_BEAMS
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
    from rplidar_ros2_driver_tpu_torch.ops.scan_match import pose_to_metric

    b = beams or DEFAULT_BEAMS
    ranges, _state = replay_through_chain(
        revolutions, params, beams=b, capacity=capacity, chunk=chunk
    )
    theta = ((np.arange(b) + 0.5) * (2.0 * np.pi / b)).astype(np.float32)
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    mapper = FleetMapper(params, 1, beams=b)
    engine = None
    if with_loop:
        from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine

        engine = LoopClosureEngine(params, mapper)
        engine.precompile()
    k_total = ranges.shape[0]
    traj = np.zeros((k_total, 3), np.float64)
    corrected = np.zeros((k_total, 3), np.float64) if with_loop else None
    scores = np.zeros((k_total,), np.int32)
    for k in range(k_total):
        finite = np.isfinite(ranges[k])
        r = np.where(finite, ranges[k], 0.0).astype(np.float32)
        pts = np.stack([r * cos_t, r * sin_t], axis=1).astype(np.float32)
        ests = mapper.submit_points(pts[None], finite[None], np.ones((1,), np.int32))
        est = ests[0]
        if engine is not None:
            engine.observe(ests)
            corrected[k] = pose_to_metric(engine.corrected_pose_q(0, est.pose_q), mapper.cfg)
        traj[k] = (est.x_m, est.y_m, est.theta_rad)
        scores[k] = est.score
    return traj, corrected, scores, mapper, engine


def replay_with_map(
    revolutions: list[dict],
    params,
    *,
    beams: int | None = None,
    capacity: int = 4096,
    chunk: int = 256,
):
    """Offline SLAM replay: a capture's revolutions through the fused filter
    chain (:func:`replay_through_chain`), then every median range image
    through the mapper (mapping/mapper.FleetMapper: correlative scan-to-map
    matching + log-odds occupancy).  The chain and the mapper run on the
    card unless ``params.filter_backend`` is ``cpu``; ``params.map_backend``
    ``auto`` is the fused device mapper on the card, the host reference on
    the CPU.

    Returns ``(trajectory, scores, mapper)``: (K, 3) float64 [x_m, y_m,
    theta_rad] per-scan poses, (K,) int32 match scores, and the mapper
    (whose ``snapshot()`` is the final map; render it with
    tools/viz.map_to_image)."""
    traj, _corrected, scores, mapper, _engine = _replay_map_core(
        revolutions, params, beams=beams, capacity=capacity, chunk=chunk, with_loop=False)
    return traj, scores, mapper


def replay_with_loop_closure(
    revolutions: list[dict],
    params,
    *,
    beams: int | None = None,
    capacity: int = 4096,
    chunk: int = 256,
):
    """Offline SLAM replay through the whole back-end: the capture's
    revolutions through the chain and the mapper exactly as in
    :func:`replay_with_map`, with a loop-closure engine
    (slam/loop.LoopClosureEngine) observing every revolution — submap
    finalizations, batched candidate matching (B6/B7 on the card), the
    pose-graph relaxation — so the corrected trajectory comes out next to
    the raw one.  ``params.loop_backend`` ``auto`` is the fused engine on
    the card, the host reference on the CPU.

    Returns ``(traj, corrected, scores, mapper, engine)``: the raw (K, 3)
    float64 trajectory, the corrected (K, 3) trajectory (equal to it until
    the first accepted closure), (K,) int32 match scores, the mapper and
    the engine (whose ``status()`` carries the closure counters)."""
    return _replay_map_core(
        revolutions, params, beams=beams, capacity=capacity, chunk=chunk, with_loop=True)


def replay_raw_fused(
    path: str,
    params,
    *,
    beams: int | None = None,
    capacity: int = 4096,
    frames_per_tick: int = 64,
    super_ticks: int = 8,
    max_revs: int = 8,
):
    """Offline replay of a RAW capture through the fused device ingest:
    frame bytes -> filtered range images on the device of
    ``params.filter_backend`` (the card unless it says ``cpu``).

    The capture's frames go ``frames_per_tick`` per tick (a run of one
    format closes a tick) through driver/ingest.FleetFusedIngest with one
    stream, drained as one backlog ``super_ticks`` ticks per super-step:
    decode, revolution segmentation and the filter steps on the device.
    For a single-scan-mode capture the ranges and the final FilterState
    equal :func:`replay_through_chain`'s over the decoded revolutions; a
    capture that switches scan modes replays with the live engine's reset
    semantics instead.  Raises if a revolution was dropped to the
    ``max_revs`` per-step cap.

    With ``params.deskew_enable`` the revolutions are de-skewed before the
    filter (the host twin is then ops/deskew_ref.DeskewHostTwin + chain)
    and every reconstructed sweep lands in ``stats["recon_history"]``.

    Returns ``(ranges, state, stats)``: (K, beams) float32 median range
    images, the final FilterState on the host, and a stats dict with
    ``ticks`` / ``dispatches`` / ``super_dispatches`` / ``super_tick`` /
    ``frames`` / ``scans`` (+ ``recon_sweeps`` / ``recon_history``)."""
    from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest

    ticks: list = []
    cur_ans: int | None = None
    cur: list = []

    def close_run() -> None:
        for i in range(0, len(cur), frames_per_tick):
            ticks.append([(cur_ans, cur[i : i + frames_per_tick])])
        cur.clear()

    n_frames = 0
    for ans_type, ts, payload in read_frames(path):
        expect = ANS_PAYLOAD_BYTES.get(ans_type)
        if expect is None or len(payload) != expect:
            continue  # non-measurement or malformed record
        if cur_ans != ans_type:
            close_run()
            cur_ans = ans_type
        cur.append((payload, ts))
        n_frames += 1
    close_run()

    eng = FleetFusedIngest(
        params, 1, beams=beams, capacity=capacity, max_revs=max_revs,
        max_queue=1 << 30,  # offline: every result must survive to the drain
        buckets=(frames_per_tick,), super_tick_max=super_ticks,
    )
    eng.recon_log = eng._deskew is not None
    outs = eng.submit_backlog(ticks)[0] if ticks else []
    if eng.revs_dropped:
        raise ValueError(
            f"{eng.revs_dropped} revolutions dropped to the max_revs={max_revs} "
            "per-step cap — raise max_revs or lower frames_per_tick to keep "
            "the host-path parity contract"
        )
    ranges = (
        np.stack([np.asarray(o.ranges) for o, _, _ in outs])
        if outs else np.zeros((0, eng.cfg.beams), np.float32)
    )
    stats = {
        "ticks": eng.ticks,
        "dispatches": eng.dispatch_count,
        "super_dispatches": eng.super_dispatches,
        "super_tick": super_ticks,
        "frames": n_frames,
        "scans": len(outs),
    }
    if eng._deskew is not None:
        stats["recon_sweeps"] = len(eng.recon_history[0])
        stats["recon_history"] = eng.recon_history[0]
    return ranges, eng.filter_state_of(0), stats

