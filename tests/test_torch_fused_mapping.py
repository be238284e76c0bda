"""The fused mapping route of the PyTorch package against the JAX package's.

With ``fused_mapping_backend='fused'`` the per-stream MapState rides the
fleet ingest state and each tick's reconstructed sweep is matched and
absorbed inside the ingest step (the port: ops/scan_match.
fleet_map_match_step once a tick for the whole fleet).  These cases follow
the JAX package's tests/test_fused_mapping.py case for case at its
geometry (256 beams, a 32² map at 0.2 m, 400-point revolutions with
radial drift, 4 frames a tick), each run through both packages on the CPU
from the same seeded bytes: the service routes, the dispatch counts, a
mid-backlog format switch, idle ticks and short backlogs, snapshots (mid
super-tick, version skew, FleetMapper rows, JAX -> port -> JAX), the
loop-closure tap and the seam validation (the ops-level super-step is
tests/test_torch_fused_mapping_ops.py).  Every compared value is
byte-equal; the JAX ``pallas`` matcher runs in interpret mode, as its own
tests run it.
"""

from __future__ import annotations

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.ops import wire as jwire
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh as jmake_mesh
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver import ingest as tdi
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.ops import ingest as ti
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService as TService
from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh as tmake_mesh
from rplidar_ros2_driver_tpu_torch.protocol import timing as ttiming
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
MAP_KEYS = ("log_odds", "pose", "origin_xy", "revision")


def _params(pkg: str, route: str = "fused", **over):
    base = dict(
        filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
        voxel_grid_size=16, fleet_ingest_backend="fused", deskew_enable=True,
        sweep_reconstruct_window=3, deskew_profile_beams=64, deskew_shift_window=4,
        map_enable=True, map_backend="host", fused_mapping_backend=route, map_grid=32,
        map_cell_m=0.2,
    )
    base.update(over)
    return (JParams if pkg == "jax" else TParams)(**base)


def dense_frames(revs: int, ppr: int = 400, drift_per_rev: float = 40.0, seed: int = 0):
    """Dense-capsule bytes with radial drift (a moving platform, so the
    de-skew estimator and the matcher both do real work)."""
    rng = np.random.default_rng(seed)
    frames, idx, first = [], 0, True
    while idx < revs * ppr:
        theta = 360.0 * (idx % ppr) / ppr
        pts = (np.arange(40) + idx) % ppr
        dists = (2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr) + drift_per_rev * (idx / ppr)
                 + rng.uniform(0.0, 0.25))
        frames.append(jwire.encode_dense_capsule(int(theta * 64) & 0x7FFF, first,
                                                 dists.astype(int)))
        idx += 40
        first = False
    return frames


def byte_ticks(frames, streams: int, run: int = 4, t0: float = 100.0, ans: int = DENSE):
    """Per-stream byte ticks: every stream the same frames on its own
    stamp lane."""
    ticks = []
    t = [t0 + 5.0 * s for s in range(streams)]
    for i in range(0, len(frames), run):
        tick = []
        for s in range(streams):
            batch = []
            for f in frames[i : i + run]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append((ans, batch))
        ticks.append(tick)
    return ticks


def build(pkg: str, route: str, streams: int, match_backend: str = "xla",
          super_tick_max: int = 1, **over):
    params = _params(pkg, route, match_backend=match_backend,
                     super_tick_max=super_tick_max, **over)
    if pkg == "jax":
        svc = JService(params, streams, mesh=jmake_mesh(1), beams=BEAMS, capacity=1024,
                       fleet_ingest_buckets=(4,))
    else:
        svc = TService(params, streams, mesh=tmake_mesh(device="cpu"), beams=BEAMS,
                       capacity=1024, fleet_ingest_buckets=(4,))
    svc._ensure_byte_ingest()
    svc.attach_mapper()
    return svc


def pose_row(svc):
    return [None if p is None else (tuple(int(v) for v in p.pose_q), p.score,
                                    p.matched_points, p.revision)
            for p in svc.last_poses]


def assert_maps_equal(a, b, what=""):
    for k in MAP_KEYS:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{what} {k}")
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (what, k)


def assert_outputs_equal(a, b, what=""):
    assert (a is None) == (b is None), what
    if a is not None:
        for name in ("ranges", "intensities", "point_mask", "voxel"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), err_msg=f"{what} {name}")


def assert_snapshots_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        np.testing.assert_array_equal(x, y, err_msg=k)  # nan equals nan here
        assert x.dtype == y.dtype, k


# ---------------------------------------------------------------------------
# the service routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("match_backend", ["xla", "pallas"])
def test_service_route_parity(match_backend):
    """Host route against fused route through the service, tick by tick,
    in both packages: outputs, per-tick poses and final maps byte-equal;
    the fused route launches no mapper step."""
    streams = 3
    arms = {(pkg, route): build(pkg, route, streams, match_backend)
            for pkg in ("jax", "torch") for route in ("host", "fused")}
    for n, t in enumerate(byte_ticks(dense_frames(3), streams)):
        res = {key: svc.submit_bytes(t) for key, svc in arms.items()}
        want = res[("jax", "fused")]
        for key, got in res.items():
            for i in range(streams):
                assert_outputs_equal(want[i], got[i], f"{key} tick {n} stream {i}")
        rows = {key: pose_row(svc) for key, svc in arms.items()}
        assert all(r == rows[("jax", "fused")] for r in rows.values()), (n, rows)
    want = arms[("jax", "fused")].mapper.snapshot()
    for key, svc in arms.items():
        assert_maps_equal(svc.mapper.snapshot(), want, str(key))
    assert arms[("torch", "fused")].mapper.dispatch_count == 0
    assert arms[("torch", "fused")].mapper.ticks > 0
    assert arms[("torch", "host")].mapper.ticks > 0
    assert type(arms[("torch", "fused")].mapper).__name__ == "CarriedFleetMapper"


def test_backlog_drain_dispatch_collapse():
    """T ticks of ingest + mapping in ceil(T / super_tick_max) steps, no
    mapper step, the final map equal to the per-tick host route's and to
    the JAX package's drain."""
    streams, T = 3, 4
    ticks = byte_ticks(dense_frames(3), streams)
    h = build("torch", "host", streams)
    for t in ticks:
        h.submit_bytes(t)
    f = build("torch", "fused", streams, super_tick_max=T)
    jf = build("jax", "fused", streams, super_tick_max=T)
    d0 = f.fleet_ingest.dispatch_count
    outs = f.submit_bytes_backlog(ticks)
    jouts = jf.submit_bytes_backlog(ticks)
    assert f.fleet_ingest.dispatch_count - d0 == -(-len(ticks) // T)
    assert f.mapper.dispatch_count == 0
    assert_maps_equal(f.mapper.snapshot(), h.mapper.snapshot(), "host route")
    assert_maps_equal(f.mapper.snapshot(), jf.mapper.snapshot(), "jax drain")
    assert pose_row(f) == pose_row(jf)
    for i in range(streams):
        assert len(outs[i]) == len(jouts[i])
        for a, b in zip(jouts[i], outs[i]):
            assert_outputs_equal(a, b, f"stream {i}")


def test_mid_backlog_format_switch():
    """Stream 0 switches to HQ capsules mid-backlog: the decode reset and
    the ring invalidation land at its own tick inside the super-step, the
    carried map survives, and both routes of both packages agree."""
    streams = 2
    hq_rev, idx, ppr = [], 0, 384
    while idx < 2 * ppr:
        pts = (np.arange(96) + idx) % ppr
        dists = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr)
        hq_rev.append(jwire.encode_hq_capsule((pts * 65536) // ppr, (dists * 4).astype(np.int64),
                                              np.full(96, 190), np.where(pts == 0, 1, 0)))
        idx += 96
    hq_ticks = byte_ticks(hq_rev, streams, t0=200.0, ans=int(Ans.MEASUREMENT_HQ))
    for t in hq_ticks:
        t[1] = None
    scene = byte_ticks(dense_frames(2), streams) + hq_ticks
    h = build("torch", "host", streams)
    for t in scene:
        h.submit_bytes(t)
    f = build("torch", "fused", streams, super_tick_max=4)
    jf = build("jax", "fused", streams, super_tick_max=4)
    f.submit_bytes_backlog(scene)
    jf.submit_bytes_backlog(scene)
    assert_maps_equal(f.mapper.snapshot(), h.mapper.snapshot(), "host route")
    assert_maps_equal(f.mapper.snapshot(), jf.mapper.snapshot(), "jax")
    assert int(f.mapper.snapshot()["revision"][0]) > 0


def test_all_idle_tick_does_not_republish_stale_poses():
    """A tick that pushes no sub-sweep anywhere lands ``last_poses = [None]
    * streams``, in both packages, after ticks that published poses."""
    streams = 2
    arms = [build(pkg, "fused", streams) for pkg in ("jax", "torch")]
    for t in byte_ticks(dense_frames(2), streams):
        for svc in arms:
            svc.submit_bytes(t)
    assert pose_row(arms[0]) == pose_row(arms[1])
    assert any(p is not None for p in arms[1].last_poses)
    for svc in arms:
        svc.submit_bytes([None] * streams)
        assert svc.last_poses == [None] * streams


@pytest.mark.parametrize("n_ticks", [1, 3])
def test_backlog_shorter_than_T_pads_with_idle_wires(n_ticks):
    """A backlog shorter than T pads the super-step with all-idle ticks,
    whose wires carry live = 0: the drain's newest wire per stream, its
    poses and the map equal the JAX package's, and a drain that ends on
    pad ticks publishes no pose."""
    streams, T = 2, 8
    ticks = byte_ticks(dense_frames(2), streams)
    arms = [build(pkg, "fused", streams, super_tick_max=T) for pkg in ("jax", "torch")]
    for svc in arms:
        svc.submit_bytes_backlog(ticks[: 2 * T])
    for svc in arms:
        svc.submit_bytes_backlog(ticks[2 * T : 2 * T + n_ticks])
    jw, tw = (svc.fleet_ingest.last_map_wires for svc in arms)
    for i in range(streams):
        np.testing.assert_array_equal(tw[i], jw[i])
        assert int(tw[i][0]) == 0  # the pad tick came last
    assert pose_row(arms[0]) == pose_row(arms[1]) == [None] * streams
    assert_maps_equal(arms[1].mapper.snapshot(), arms[0].mapper.snapshot())
    assert arms[1].fleet_ingest.take_map_wires() == [None] * streams


# ---------------------------------------------------------------------------
# snapshots of the carried map
# ---------------------------------------------------------------------------


def test_snapshot_restore_mid_super_tick():
    """Per-stream snapshots (v3: the map rows inside the ingest unit) taken
    mid-run and restored with ``restore_decode=True`` into a fresh service
    resume bit for bit; the port restores the JAX package's snapshots."""
    streams = 2
    ticks = byte_ticks(dense_frames(4), streams)
    cut = len(ticks) // 2
    ref = build("torch", "fused", streams, super_tick_max=2)
    jref = build("jax", "fused", streams, super_tick_max=2)
    for t in ticks[:cut]:
        ref.submit_bytes(t)
        jref.submit_bytes(t)
    snaps = [ref.fleet_ingest.snapshot_stream(i) for i in range(streams)]
    jsnaps = [jref.fleet_ingest.snapshot_stream(i) for i in range(streams)]
    for s, js in zip(snaps, jsnaps):
        assert any(k.startswith("ingest.map_") for k in s)
        assert_snapshots_equal(s, js)
    dst = build("torch", "fused", streams, super_tick_max=2)
    from_jax = build("torch", "fused", streams, super_tick_max=2)
    for i in range(streams):
        assert dst.fleet_ingest.restore_stream(i, snaps[i], restore_decode=True)
        assert from_jax.fleet_ingest.restore_stream(i, jsnaps[i], restore_decode=True)
    for t in ticks[cut:]:
        for svc in (ref, jref, dst, from_jax):
            svc.submit_bytes(t)
        assert pose_row(ref) == pose_row(dst) == pose_row(from_jax) == pose_row(jref)
    for svc in (dst, from_jax, jref):
        assert_maps_equal(svc.mapper.snapshot(), ref.mapper.snapshot())


def test_snapshot_version_skew_rejected():
    """A v2-stamped snapshot is rejected with the state untouched, and a
    snapshot without the map rows cannot ``restore_decode`` into a
    mapping engine; the plain rejoin restore ignores ingest rows."""
    streams = 2
    svc = build("torch", "fused", streams)
    for t in byte_ticks(dense_frames(1), streams):
        svc.submit_bytes(t)
    snap = svc.fleet_ingest.snapshot_stream(0)
    assert int(snap["version"]) == tdi.INGEST_STREAM_SNAPSHOT_VERSION == 3
    before = svc.fleet_ingest.snapshot()
    bad = dict(snap, version=np.asarray(2, np.int32))
    assert not svc.fleet_ingest.restore_stream(0, bad)
    assert not svc.fleet_ingest.restore_stream(0, bad, restore_decode=True)
    stripped = {k: v for k, v in snap.items() if not k.startswith("ingest.map_")}
    assert not svc.fleet_ingest.restore_stream(0, stripped, restore_decode=True)
    assert_snapshots_equal(svc.fleet_ingest.snapshot(), before)
    assert svc.fleet_ingest.restore_stream(0, stripped)


def test_carried_map_checkpoint_interops_with_fleetmapper():
    """The carried face's per-stream map rows are FleetMapper's format
    byte for byte: a row from the carry restores into a host FleetMapper
    (of either package) and back; version skew is rejected."""
    from rplidar_ros2_driver_tpu.mapping.mapper import FleetMapper as JFleetMapper

    streams = 2
    f = build("torch", "fused", streams)
    for t in byte_ticks(dense_frames(2), streams):
        f.submit_bytes(t)
    row = f.mapper.snapshot_stream(0)
    assert int(row["revision"]) > 0
    assert_maps_equal(tmapper.carried_map_row(f.fleet_ingest.snapshot_stream(0)), row)
    host = tmapper.FleetMapper(_params("torch", "host"), streams, beams=BEAMS)
    jhost = JFleetMapper(_params("jax", "host"), streams, beams=BEAMS)
    assert host.restore_stream(1, row) and jhost.restore_stream(1, row)
    back = host.snapshot_stream(1)
    assert_maps_equal(back, row)
    assert_maps_equal(jhost.snapshot_stream(1), row)
    assert f.mapper.restore_stream(1, back)
    assert_maps_equal(f.mapper.snapshot_stream(1), row)
    assert not f.mapper.restore_stream(0, dict(row, version=np.asarray(99, np.int32)))
    # the whole-fleet face: restore, cold reset
    full = f.mapper.snapshot()
    assert f.mapper.restore(full)
    assert_maps_equal(f.mapper.snapshot(), full)
    assert not f.mapper.restore(None)
    assert int(np.abs(f.mapper.snapshot()["log_odds"]).max()) == 0
    pose = np.asarray([5 * 32, -3 * 32, f.mapper.cfg.theta_divisions + 7], np.int32)
    f.mapper.reanchor_stream(1, pose)
    assert f.mapper.snapshot_stream(1)["pose"].tolist() == [160, -96, 7]


def test_fleet_snapshots_round_trip_jax_port_jax():
    """The v3 whole-fleet snapshot (``ingest.map_*`` planes) and the
    per-stream one go JAX -> port -> JAX, and each run continued from them
    stays byte-equal to the uninterrupted JAX run."""
    streams = 2
    ticks = byte_ticks(dense_frames(4), streams)
    cut = len(ticks) // 2
    jref = build("jax", "fused", streams)
    for t in ticks[:cut]:
        jref.submit_bytes(t)
    jsnap = {k: np.array(v) for k, v in jref.fleet_ingest.snapshot().items()}
    assert any(k.startswith("ingest.map_") for k in jsnap)
    port = build("torch", "fused", streams)
    assert port.fleet_ingest.restore(jsnap)
    assert_snapshots_equal(port.fleet_ingest.snapshot(), jsnap)
    back = build("jax", "fused", streams)
    assert back.fleet_ingest.restore(port.fleet_ingest.snapshot())
    rows = [port.fleet_ingest.snapshot_stream(i) for i in range(streams)]
    back_rows = build("jax", "fused", streams)
    for i, r in enumerate(rows):
        assert back_rows.fleet_ingest.restore_stream(i, r, restore_decode=True)
    for t in ticks[cut:]:
        for svc in (jref, port, back, back_rows):
            svc.submit_bytes(t)
        assert pose_row(port) == pose_row(jref) == pose_row(back) == pose_row(back_rows)
    for svc in (port, back, back_rows):
        assert_maps_equal(svc.mapper.snapshot(), jref.mapper.snapshot())
    # a mapping-off engine refuses the mapping snapshot's key space
    plain = build("torch", "host", streams)
    assert not plain.fleet_ingest.restore(jsnap)


# ---------------------------------------------------------------------------
# the loop-closure tap and the seams
# ---------------------------------------------------------------------------


def test_loop_closure_tap_parity():
    """The loop engine observes the fused route as it observes the host
    route: the same installs, checks and corrected poses, in both
    packages."""
    streams = 2
    over = dict(loop_enable=True, loop_backend="host", loop_submap_revs=2, loop_check_revs=2,
                loop_max_submaps=4, loop_candidates=1, loop_min_points=4, pose_graph_iters=16)
    arms = [build(pkg, route, streams, **over) for pkg in ("jax", "torch")
            for route in ("host", "fused")]
    for svc in arms:
        svc.attach_loop_closure()

    def corrected(svc):
        return [None if c is None else tuple(int(v) for v in c) for c in svc.last_corrected_poses]

    for t in byte_ticks(dense_frames(4), streams):
        for svc in arms:
            svc.submit_bytes(t)
        assert all(corrected(svc) == corrected(arms[0]) for svc in arms)
    assert arms[3].loop.installs == arms[0].loop.installs > 0
    assert all(svc.loop.checks == arms[0].loop.checks for svc in arms)


def test_seam_validation():
    """The fused route refuses to build half-wired, as the JAX package's."""
    with pytest.raises(ValueError, match="requires map_enable"):
        _params("torch", "fused", map_enable=False).validate()
    with pytest.raises(ValueError, match="requires deskew_enable"):
        _params("torch", "fused", deskew_enable=False).validate()
    with pytest.raises(ValueError, match="fleet_ingest_backend"):
        _params("torch", "fused", fleet_ingest_backend="auto", ingest_backend="fused").validate()
    _params("torch", "fused").validate()
    with pytest.raises(ValueError, match="requires deskew_enable"):
        tdi.FleetFusedIngest(_params("torch", "fused", deskew_enable=False), 2, beams=BEAMS)
    svc = build("torch", "fused", 2)
    with pytest.raises(ValueError, match="fused_mapping_backend"):
        svc.attach_mapper(tmapper.FleetMapper(_params("torch", "host"), 2, beams=BEAMS))
    with pytest.raises(RuntimeError, match="absorb_wires"):
        svc.mapper.submit([None, None])
    with pytest.raises(RuntimeError, match="absorb_wires"):
        svc.mapper.submit_points(None, None, None)
    assert tmapper.is_carried(svc.mapper) and not tmapper.is_carried(
        build("torch", "host", 2).mapper)
    assert tmapper.resolve_fused_mapping_backend("auto", "cuda") == "host"
    plain = tdi.FleetFusedIngest(_params("torch", "host"), 2, beams=BEAMS)
    for call in (plain.map_snapshot, lambda: plain.map_snapshot_stream(0),
                 lambda: plain.map_reanchor_stream(0, np.zeros(3, np.int32))):
        with pytest.raises(RuntimeError, match="carries no map"):
            call()
    with pytest.raises(ValueError, match="fused mapping route"):
        tmapper.CarriedFleetMapper(_params("torch", "host"), plain)
    with pytest.raises(ValueError, match="requires the de-skew"):
        ti.fleet_ingest_config_for((DENSE,), ttiming.TimingDesc(),
                                   svc.fleet_ingest.cfg, mapping=svc.mapper.cfg)
