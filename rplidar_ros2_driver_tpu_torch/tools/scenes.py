"""The seeded scenes the port's smoke run and its tests are driven with.

One copy of each input builder, shared by ``chip_smoke.py``,
:mod:`rplidar_ros2_driver_tpu_torch.tools.graded` and the port's tests:

* :func:`wire_frames` — bench.py ``_denseboost_wire_frames``: the static
  2 m ± 0.5 m ring in dense capsules;
* :func:`denseboost_frames` — a seeded DenseBoost capture of that ring with
  noise, drop-outs and returns beyond range (config 7's replay);
* :func:`paced_fleet_ticks` — bench.py ``_paced_fleet_byte_ticks``;
* :func:`host_scans` — bench.py ``_host_scans``;
* :func:`make_revolutions` — seeded raw revolutions with angle jitter;
* :func:`room_ticks` and :func:`room_scan` — bench.py ``_room_fleet_ticks``'
  5 x 5 m room from drifting poses, as point planes or as wire nodes.

Every builder is deterministic: the same arguments give the same bytes.
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)


def wire_frames(revs: int, points_per_rev: int) -> list[bytes]:
    """bench.py ``_denseboost_wire_frames``: dense capsules of 40 samples
    of a 2 m ± 0.5 m ring (no noise: the scene is static), ``revs``
    revolutions."""
    from rplidar_ros2_driver_tpu_torch.ops import wire

    frames, idx, total = [], 0, revs * points_per_rev
    while idx < total:
        theta = 360.0 * (idx % points_per_rev) / points_per_rev
        pts = (np.arange(40) + idx) % points_per_rev
        dists_mm = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / points_per_rev)
        frames.append(wire.encode_dense_capsule(int(theta * 64) & 0x7FFF, idx == 0,
                                                dists_mm.astype(int)))
        idx += 40
    return frames


def denseboost_frames(seed: int, revs: int, points: int) -> list[bytes]:
    """Seeded DenseBoost capture (dense capsules of 40 samples; the pattern
    of bench.py's _denseboost_wire_frames): a 2 m +/- 0.5 m ring with 10 mm
    noise, 5% drop-outs and 2% returns beyond range_max."""
    from rplidar_ros2_driver_tpu_torch.ops import wire

    rng = np.random.default_rng(seed)
    frames = []
    for n, idx in enumerate(range(0, revs * points, 40)):
        pts = (np.arange(40) + idx) % points
        mm = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / points + 0.1 * (idx // points))
        mm = mm + rng.normal(0.0, 10.0, 40)
        mm[rng.random(40) < 0.05] = 0
        mm[rng.random(40) < 0.02] = 50000
        start_q6 = int(360.0 * (idx % points) / points * 64) & 0x7FFF
        frames.append(wire.encode_dense_capsule(start_q6, n == 0, mm.astype(int)))
    return frames


def paced_fleet_ticks(frames, run: int, streams: int, ans: int = DENSE) -> list:
    """bench.py ``_paced_fleet_byte_ticks``: ``run`` frames a stream a
    tick, every stream the same frames on its own timestamp lane (7 s
    apart, 1.25 ms a frame)."""
    ticks = []
    t = [1000.0 + 7.0 * s for s in range(streams)]
    for i in range(0, len(frames), run):
        tick = []
        for s in range(streams):
            batch = []
            for f in frames[i: i + run]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append((ans, batch))
        ticks.append(tick)
    return ticks


def host_scans(n: int, points: int) -> list[dict]:
    """bench.py ``_host_scans``: ``n`` raw revolutions of a 2 m ± 0.5 m
    ring with 1 cm of seeded noise."""
    rng = np.random.default_rng(0)
    out = []
    for k in range(n):
        angle = ((np.arange(points) * 65536) // points).astype(np.int32)
        dist_m = 2.0 + 0.5 * np.sin(np.arange(points) * (2 * np.pi / points) + 0.1 * k)
        dist_m += rng.normal(0, 0.01, points)
        out.append({"angle_q14": angle, "dist_q2": (dist_m * 4000.0).astype(np.int32),
                    "quality": np.full(points, 190, np.int32)})
    return out


def make_revolutions(seed: int, n: int, points: int) -> list[dict]:
    """Seeded DenseBoost-shaped revolutions: a 2 m +/- 0.5 m ring with
    noise, angle jitter, drop-outs (dist 0) and out-of-range points."""
    rng = np.random.default_rng(seed)
    i = np.arange(points)
    revs = []
    for k in range(n):
        angle = ((i * 65536) // points + rng.integers(-8, 9, points)).clip(0, 65535)
        dist_m = 2.0 + 0.5 * np.sin(i * (2 * np.pi / points) + 0.1 * k)
        dist_m = dist_m + rng.normal(0.0, 0.01, points)
        dist = (dist_m * 4000.0).astype(np.int32)
        dist[rng.random(points) < 0.05] = 0                  # drop-outs
        dist[rng.random(points) < 0.02] = 50 * 4000          # beyond range_max
        dist[rng.random(points) < 0.01] = int(0.05 * 4000)   # below range_min
        revs.append({
            "angle_q14": angle.astype(np.int32),
            "dist_q2": dist,
            "quality": rng.integers(0, 256, points).astype(np.int32),
            "flag": (i == 0).astype(np.int32),
        })
    return revs


def room_pose(s: int, k: int) -> tuple:
    """Stream ``s``'s true pose (x m, y m, θ rad) at tick ``k`` in the room:
    one to two cells of drift a tick at 0.05 m."""
    return 0.03 * k * (1 + 0.1 * s), -0.02 * k * (1 + 0.2 * s), 0.004 * k


def room_ticks(streams: int, beams: int, n_ticks: int) -> list[np.ndarray]:
    """bench.py ``_room_fleet_ticks``: a 5 x 5 m room seen from
    per-stream drifting poses, one (N, B, 2) float32 plane a tick."""
    half_room = 2.5
    t = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    dx, dy = np.cos(t), np.sin(t)
    with np.errstate(divide="ignore"):
        r_wall = np.minimum(
            np.where(np.abs(dx) > 1e-12, half_room / np.abs(dx), np.inf),
            np.where(np.abs(dy) > 1e-12, half_room / np.abs(dy), np.inf),
        )
    wx, wy = dx * r_wall, dy * r_wall
    ticks = []
    for k in range(n_ticks):
        pts = np.zeros((streams, beams, 2), np.float32)
        for s in range(streams):
            x0, y0, th = room_pose(s, k)
            c, si = np.cos(-th), np.sin(-th)
            pts[s, :, 0] = c * (wx - x0) - si * (wy - y0)
            pts[s, :, 1] = si * (wx - x0) + c * (wy - y0)
        ticks.append(pts)
    return ticks


def room_scan(s: int, k: int, beams: int) -> dict:
    """One revolution of the same room (stream ``s``, tick ``k``) as wire
    nodes at the beam centres: a raw revolution with no start flag."""
    x0, y0, th = room_pose(s, k)
    t = (np.arange(beams) + 0.5) * (2 * np.pi / beams)
    dx, dy = np.cos(t + th), np.sin(t + th)
    with np.errstate(divide="ignore"):
        r = np.minimum(
            np.where(np.abs(dx) > 1e-12, (2.5 - np.sign(dx) * x0) / np.abs(dx), np.inf),
            np.where(np.abs(dy) > 1e-12, (2.5 - np.sign(dy) * y0) / np.abs(dy), np.inf))
    return {"angle_q14": np.floor((np.arange(beams) + 0.5) * 65536 / beams).astype(np.int32),
            "dist_q2": np.round(r * 4000).astype(np.int32),
            "quality": np.full(beams, 180, np.int32), "flag": None}
