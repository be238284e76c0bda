"""The port's SLAM back-end (ops/loop_close, slam/loop) against the JAX
package's.

Every parity assertion is byte equality (every value is int32; the float32
input points are identical in both packages):

  * ``fleet_install_submap`` and ``fleet_loop_close_step`` at S = 1 and 3
    against the JAX package's fused program (``match_backend="xla"``) and
    against the numpy twin ``loop_close_ref`` — the port's plain arm and
    its kernel arm (``"pallas"``, whose wrappers run the plain versions on
    a CPU tensor);
  * the engine's host and CPU-``fused`` arms against the JAX engine on the
    bench's config-17 drift trace at its smoke geometry (grid 64 at 0.1 m,
    256 beams, 2 streams, 24 revolutions, 8 submaps, 96 sweeps), and on a
    matched mapper with idle streams and re-anchoring;
  * a JAX snapshot restored into the port and continued byte-equal, and
    the reverse.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.mapping import mapper as jmapper
from rplidar_ros2_driver_tpu.ops import loop_close as jlc
from rplidar_ros2_driver_tpu.slam import loop as jloop
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.mapping.submap import quantize_submap_plane, select_candidates
from rplidar_ros2_driver_tpu_torch.ops import loop_close as tlc
from rplidar_ros2_driver_tpu_torch.ops import loop_close_ref as tref
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB
from rplidar_ros2_driver_tpu_torch.slam import loop as tloop
from rplidar_ros2_driver_tpu_torch.tools.loop_drift import (
    DriftingFrontEnd,
    end_error_cells,
    loop_drift_trace,
)

# bench.py bench_loop_close(smoke=True)
SMOKE = dict(grid=64, cell=0.1, beams=256, streams=2, revs=24)
SMOKE_PARAMS = dict(
    filter_backend="cpu", filter_chain=("clip", "median", "voxel"), map_enable=True,
    map_backend="host", map_grid=SMOKE["grid"], map_cell_m=SMOKE["cell"], loop_enable=True,
    loop_submap_revs=4, loop_check_revs=2, loop_max_submaps=8, loop_candidates=2,
    loop_weight=8, pose_graph_max_constraints=32, pose_graph_iters=96,
)


def params(pkg, **kw):
    return (DriverParams if pkg == "port" else JParams)(**{**SMOKE_PARAMS, **kw})


def configs(**kw):
    """(JAX LoopConfig, port LoopConfig) of the smoke geometry."""
    jp, tp = params("jax", **kw), params("port", **kw)
    jc = jloop.loop_config_from_params(jp, jmapper.map_config_from_params(jp, SMOKE["beams"]))
    tc = tloop.loop_config_from_params(tp, tmapper.map_config_from_params(tp, SMOKE["beams"]))
    return jc, tc


def drift_trace(streams=SMOKE["streams"], revs=SMOKE["revs"]):
    return loop_drift_trace(streams, SMOKE["beams"], revs, SUB // 4, SMOKE["cell"])


def jax_state(stacked: dict):
    import jax.numpy as jnp

    # fresh copies: the JAX programs donate their state, and a CPU array may
    # alias the numpy buffer it came from
    return jlc.LoopState(**{k: jnp.asarray(np.array(stacked[k])) for k in tlc.STATE_KEYS})


def jax_numpy(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in tlc.STATE_KEYS}


def assert_same_state(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def library(streams: int, cfg, revs: int = 18):
    """S submap libraries built along the drift trace (a submap every 4
    revolutions, the host reference's install), the last revolution's
    points and the front-end's poses."""
    fe = DriftingFrontEnd(params("port"), streams, SMOKE["beams"], 4)
    trace, masks, _ = drift_trace(streams, revs)
    st = {k: np.zeros((streams,) + v, np.int32) for k, v in tlc.LoopState.shapes(cfg).items()}
    for k, (pts, drifted) in enumerate(trace):
        fe.submit(pts, masks, drifted)
        if (k + 1) % 4 == 0:
            for i in range(streams):
                row = tref.install_submap_np({key: st[key][i] for key in st},
                                             quantize_submap_plane(fe.log_odds[i], fe.cfg),
                                             fe.pose[i], cfg)
                for key in st:
                    st[key][i] = row[key]
    return st, trace[-1][0], masks, fe.pose.copy()


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


def test_loop_config_matches_jax():
    jc, tc = configs()
    assert dataclasses.asdict(tc.graph) == dataclasses.asdict(jc.graph)
    for f in dataclasses.fields(tc):
        if f.name not in ("match", "graph"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(tc.match):
        assert getattr(tc.match, f.name) == getattr(jc.match, f.name), f.name
    assert tc.match.quant_shift == 0 and tc.accept_q * tc.match.beams < 2**31
    # the candidate matcher's backend follows the engine's device
    tp = params("port")
    mc = tmapper.map_config_from_params(tp, SMOKE["beams"])
    assert tloop.loop_config_from_params(tp, mc, "cuda").match.match_backend == "pallas"
    assert tloop.loop_config_from_params(tp, mc, "cpu").match.match_backend == "xla"
    assert tlc.LOOP_STATE_VERSION == jlc.LOOP_STATE_VERSION and tlc.WIRE_LEN == jlc.WIRE_LEN


def test_loop_config_validation_matches_jax():
    jc, tc = configs()
    for over in (dict(submap_revs=0), dict(max_submaps=1), dict(check_revs=0),
                 dict(candidates=99), dict(exclude_recent=0), dict(min_points=0),
                 dict(accept_q=0), dict(accept_q=2**30), dict(peak_shift=31), dict(weight=17),
                 dict(max_constraints=0), dict(max_submaps=9), dict(max_constraints=33)):
        with pytest.raises(ValueError) as jerr:
            dataclasses.replace(jc, **over)
        with pytest.raises(ValueError) as terr:
            dataclasses.replace(tc, **over)
        assert str(terr.value) == str(jerr.value), over


def test_resolve_loop_backend_follows_the_device(monkeypatch):
    assert tloop.resolve_loop_backend("auto", "cuda") == "fused"
    assert tloop.resolve_loop_backend("auto", "cpu") == "host"
    assert tloop.resolve_loop_backend("auto", None) == "host"
    assert tloop.resolve_loop_backend("fused", "cpu") == "fused"
    fe = DriftingFrontEnd(params("port"), 1, SMOKE["beams"], 4)
    assert tloop.LoopClosureEngine(params("port", loop_backend="auto"), fe).backend == "host"
    eng = tloop.LoopClosureEngine(params("port", loop_backend="fused"), fe)
    assert eng.backend == "fused" and eng.device == torch.device("cpu")
    # the default filter_backend is the card: without one, no engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.LoopClosureEngine(params("port", filter_backend="tpu", loop_backend="auto"), fe)
    host = tloop.LoopClosureEngine(params("port", filter_backend="tpu", loop_backend="host"), fe)
    assert host.backend == "host" and host.device is None


# ---------------------------------------------------------------------------
# the device ops against the JAX program and the numpy twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("streams", [1, 3])
def test_install_submap_matches_jax_and_the_twin(streams):
    import jax.numpy as jnp

    jc, tc = configs(loop_max_submaps=3, pose_graph_max_constraints=4)
    g = tc.match.grid
    rng = np.random.default_rng(streams)
    st = {k: np.zeros((streams,) + v, np.int32) for k, v in tlc.LoopState.shapes(tc).items()}
    port = tlc.LoopState.from_numpy(st, "cpu")
    jst = jax_state(st)
    for step in range(5):                    # past the cap: 3 installs, then hold
        i = int(rng.integers(0, streams))
        plane = rng.integers(0, tc.match.clamp_q + 1, (g, g)).astype(np.int32)
        anchor = np.asarray([rng.integers(-900, 900), rng.integers(-900, 900),
                             rng.integers(0, 720)], np.int32)
        if step < 3:
            i = step % streams
        row = tref.install_submap_np({k: st[k][i] for k in st}, plane, anchor, tc)
        for k in st:
            st[k][i] = row[k]
        tlc.fleet_install_submap(port, i, torch.from_numpy(plane), torch.from_numpy(anchor), tc)
        jst = jlc.fleet_install_submap(jst, jnp.int32(i), jnp.asarray(plane), jnp.asarray(anchor),
                                       cfg=jc)
        assert_same_state(port.to_numpy(), st)
        assert_same_state(port.to_numpy(), jax_numpy(jst))
    assert int(port.count.max()) <= 3


@pytest.mark.parametrize("match_backend", ["xla", "pallas"])
@pytest.mark.parametrize("streams", [1, 3])
def test_loop_close_step_matches_jax_and_the_twin(streams, match_backend):
    import jax.numpy as jnp

    jc, tc = configs()
    tc = dataclasses.replace(tc, match=dataclasses.replace(tc.match, match_backend=match_backend))
    st, pts, masks, poses = library(streams, tc)
    rng = np.random.default_rng(7 + streams)
    masks = masks & (rng.uniform(size=masks.shape) > 0.05)
    count = st["count"]
    cand = np.stack([select_candidates(st["anchors"][i], st["valid"][i], int(count[i]),
                                       poses[i], tc) for i in range(streams)])
    if streams > 1:
        cand[1] = [cand[1][0], -1]               # one slot left empty
    check = np.ones((streams,), np.int32)
    if streams > 2:
        check[2] = 0                             # a stream not due passes through

    port, wire, corrected = tlc.fleet_loop_close_step(
        tlc.LoopState.from_numpy(st, "cpu"), torch.from_numpy(pts), torch.from_numpy(masks),
        torch.from_numpy(poses), torch.from_numpy(cand), torch.from_numpy(check), tc)
    jst, jwire, jcorr = jlc.fleet_loop_close_step(
        jax_state(st), jnp.asarray(pts), jnp.asarray(masks), jnp.asarray(poses),
        jnp.asarray(cand), jnp.asarray(check), cfg=jc)
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jwire))
    np.testing.assert_array_equal(corrected.numpy(), np.asarray(jcorr))
    assert_same_state(port.to_numpy(), jax_numpy(jst))
    for i in range(streams):
        new, w, c = tref.loop_close_step_np({k: st[k][i] for k in st}, pts[i], masks[i],
                                            poses[i], cand[i], int(check[i]), tc)
        np.testing.assert_array_equal(wire[i].numpy(), w)
        np.testing.assert_array_equal(corrected[i].numpy(), c)
        for k in st:
            np.testing.assert_array_equal(port.to_numpy()[k][i], new[k], err_msg=k)
    assert int(wire[:, 0].sum()) > 0             # the trace closes a loop
    if streams > 2:
        assert_same_state({k: v[2] for k, v in port.to_numpy().items()},
                          {k: v[2] for k, v in st.items()})


def test_saturated_false_candidate_rejected():
    """A submap saturated to the clamp everywhere scores maximal and FLAT
    across the whole (dθ, dx, dy) volume: the contrast gate rejects it in
    the port's device arm and its twin alike."""
    _, tc = configs()
    g = tc.match.grid
    st = tref.create_loop_state_np(tc)
    sat = np.full((g, g), tc.match.clamp_q, np.int32)
    st = tref.install_submap_np(st, sat, np.zeros(3, np.int32), tc)
    st = tref.install_submap_np(st, sat, np.asarray([64, 0, 0], np.int32), tc)
    # a room small enough that every candidate keeps every endpoint inside
    t = np.linspace(0, 2 * np.pi, SMOKE["beams"], endpoint=False)
    r = np.minimum(1.2 / np.maximum(np.abs(np.cos(t)), 1e-12),
                   1.2 / np.maximum(np.abs(np.sin(t)), 1e-12))
    pts = np.stack([np.cos(t) * r, np.sin(t) * r], 1).astype(np.float32)
    m = np.ones(SMOKE["beams"], bool)
    cand = np.asarray([0, -1], np.int32)
    new, wire, _ = tref.loop_close_step_np(st, pts, m, np.zeros(3, np.int32), cand, 1, tc)
    assert wire[0] == 0 and wire[2] > 0 and int(new["ncons"]) == 0
    stacked = {k: np.asarray(v)[None] for k, v in st.items()}
    _, twire, _ = tlc.loop_close_step(tlc.LoopState.from_numpy(stacked, "cpu"),
                                      torch.from_numpy(pts), torch.from_numpy(m),
                                      torch.zeros(3, dtype=torch.int32), torch.from_numpy(cand),
                                      1, tc)
    np.testing.assert_array_equal(twire.numpy(), wire)


def test_check_without_candidates_is_a_noop():
    jc, tc = configs()
    st = {k: np.asarray(v)[None] for k, v in tref.create_loop_state_np(tc).items()}
    _, pts, masks, _ = library(1, tc, revs=4)
    pose = np.asarray([10, 20, 3], np.int32)
    cand = np.full((tc.candidates,), -1, np.int32)
    port, wire, _ = tlc.loop_close_step(tlc.LoopState.from_numpy(st, "cpu"),
                                        torch.from_numpy(pts[0]), torch.from_numpy(masks[0]),
                                        torch.from_numpy(pose), torch.from_numpy(cand), 1, tc)
    w = wire.numpy()
    assert w[0] == 0 and w[1] == -1 and w[2] == 0
    np.testing.assert_array_equal(w[4:7], pose)  # an empty library: the pose itself
    assert_same_state({k: v[0] for k, v in port.to_numpy().items()},
                      {k: v[0] for k, v in st.items()})
    _, jwire, _ = jlc.loop_close_step(jlc.LoopState.create(jc), pts[0], masks[0], pose, cand,
                                      np.int32(1), cfg=jc)
    np.testing.assert_array_equal(w, np.asarray(jwire))


# ---------------------------------------------------------------------------
# the engine on the config-17 drift trace (the bench's smoke geometry)
# ---------------------------------------------------------------------------


def run_drift(pkg: str, backend: str, trace, masks, start=None, stop=None, carry=None):
    """One arm of the drift trace: (engine, front-end, per-tick statuses).
    ``carry`` = (front-end arrays, engine snapshot) to resume from."""
    p = params(pkg, loop_backend=backend)
    fe_cls = DriftingFrontEnd if pkg == "port" else bench._DriftingFrontEnd
    engine_cls = tloop.LoopClosureEngine if pkg == "port" else jloop.LoopClosureEngine
    fe = fe_cls(p, SMOKE["streams"], SMOKE["beams"], 4)
    eng = engine_cls(p, fe)
    eng.precompile()
    if carry is not None:
        fe.log_odds[:], fe.pose[:], fe.rev[:] = carry[0]
        assert eng.restore(carry[1])
    log = []
    for pts, drifted in trace[start:stop]:
        sts = eng.observe(fe.submit(pts, masks, drifted))
        log.append([None if s is None else (s.accepted, s.candidate, s.score, s.matched_points,
                                            tuple(int(v) for v in s.corrected_q),
                                            tuple(int(v) for v in s.correction_q),
                                            s.constraints, s.dropped) for s in sts])
    return eng, fe, log


@pytest.fixture(scope="module")
def drift_reference():
    trace, masks, true_end = drift_trace()
    return trace, masks, true_end, run_drift("jax", "host", trace, masks)


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_engine_matches_jax_on_the_drift_trace(backend, drift_reference):
    trace, masks, true_end, (jeng, jfe, jlog) = drift_reference
    eng, fe, log = run_drift("port", backend, trace, masks)
    assert eng.backend == backend
    assert log == jlog
    assert_same_state(eng.snapshot(), jeng.snapshot())
    assert {**eng.status(), "backend": "host"} == jeng.status()
    check_ticks = sum(any(s is not None for s in tick) for tick in log)
    assert eng.dispatch_count == (check_ticks if backend == "fused" else 0)
    assert eng.checks == jeng.checks and eng.installs == jeng.installs
    # drift bounded: the corrected end pose within 2 cells, the baseline not
    assert int(eng.closures_accepted.sum()) > 0
    for s in range(SMOKE["streams"]):
        assert end_error_cells(fe.pose[s], true_end[s]) >= 4.0
        assert end_error_cells(eng.corrected_pose_q(s, fe.pose[s]), true_end[s]) <= 2.0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_carries_across_packages(direction, drift_reference):
    """A snapshot taken half way by one package restores into the other
    and the run continues byte-equal to the uninterrupted JAX run."""
    trace, masks, _, (jeng, _jfe, jlog) = drift_reference
    half = SMOKE["revs"] // 2
    first, second = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    eng, fe, log = run_drift(first, "host" if first == "jax" else "fused", trace, masks,
                             stop=half)
    carry = ((fe.log_odds.copy(), fe.pose.copy(), fe.rev.copy()), eng.snapshot())
    eng2, _fe2, log2 = run_drift(second, "fused" if second == "port" else "host", trace, masks,
                                 start=half, carry=carry)
    assert log + log2 == jlog
    assert_same_state(eng2.snapshot(), jeng.snapshot())


# ---------------------------------------------------------------------------
# the engine beside a matching mapper: idle streams, re-anchoring
# ---------------------------------------------------------------------------

BEAMS = 128
MAPPED = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), map_enable=True,
              map_backend="host", map_grid=64, map_cell_m=0.1, loop_enable=True,
              loop_submap_revs=3, loop_check_revs=2, loop_max_submaps=6, loop_candidates=2,
              pose_graph_iters=64)


def room_points(pose_xyt, n=BEAMS, half=2.5):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    dx, dy = np.cos(t), np.sin(t)
    with np.errstate(divide="ignore"):
        r = np.minimum(np.where(np.abs(dx) > 1e-12, half / np.abs(dx), np.inf),
                       np.where(np.abs(dy) > 1e-12, half / np.abs(dy), np.inf))
    wx, wy = dx * r, dy * r
    x0, y0, th = pose_xyt
    c, s = np.cos(-th), np.sin(-th)
    return (np.stack([c * (wx - x0) - s * (wy - y0), s * (wx - x0) + c * (wy - y0)], 1)
            .astype(np.float32), np.ones(n, bool))


def drive(pkg: str, backend: str, streams: int, ticks: int = 14, map_backend="host", **kw):
    p = (DriverParams if pkg == "port" else JParams)(
        **{**MAPPED, "loop_backend": backend, "map_backend": map_backend, **kw})
    mapper = (tmapper if pkg == "port" else jmapper).FleetMapper(p, streams, beams=BEAMS)
    eng = (tloop if pkg == "port" else jloop).LoopClosureEngine(p, mapper)
    log = []
    for k in range(ticks):
        pts = np.zeros((streams, BEAMS, 2), np.float32)
        masks = np.zeros((streams, BEAMS), bool)
        live = np.zeros((streams,), np.int32)
        for s in range(streams):
            if (k + s) % 5 == 4:
                continue                         # idle this tick
            pp, mm = room_points((0.05 * k * (1 + 0.2 * s), -0.03 * k, 0.002 * k))
            mm &= np.random.default_rng(10 * s + k).uniform(size=BEAMS) > 0.05
            pts[s], masks[s], live[s] = pp, mm, 1
        sts = eng.observe(mapper.submit_points(pts, masks, live))
        log.append([None if st is None else (st.accepted, st.candidate, st.score,
                                             tuple(int(v) for v in st.corrected_q),
                                             st.constraints) for st in sts])
    return eng, mapper, log


@pytest.mark.parametrize("streams", [1, 3])
def test_engine_beside_the_mapper_matches_jax(streams):
    jeng, jm, jlog = drive("jax", "host", streams)
    for backend, map_backend in (("host", "host"), ("fused", "fused")):
        eng, m, log = drive("port", backend, streams, map_backend=map_backend)
        assert log == jlog, backend
        assert_same_state(eng.snapshot(), jeng.snapshot())
        assert int(eng._count.sum()) > 0 and eng.checks == jeng.checks


def test_reanchor_matches_jax():
    jeng, jm, jlog = drive("jax", "host", 2, loop_reanchor=True)
    eng, m, log = drive("port", "fused", 2, map_backend="fused", loop_reanchor=True)
    assert log == jlog and int(eng.closures_accepted.sum()) > 0
    assert_same_state(eng.snapshot(), jeng.snapshot())
    for k, v in jm.snapshot().items():
        np.testing.assert_array_equal(m.snapshot()[k], v, err_msg=k)
    np.testing.assert_array_equal(eng._corr, 0)


def test_library_caps_and_holds():
    eng, _, _ = drive("port", "fused", 1, ticks=30, loop_submap_revs=1, loop_max_submaps=4)
    snap = eng.snapshot()
    assert int(eng._count[0]) == 4 and int(snap["count"][0]) == 4
    assert snap["valid"][0].sum() == 4 and eng.installs == 4


def test_stream_rows_round_trip_and_reject():
    host, _, _ = drive("port", "host", 2)
    fused, _, _ = drive("port", "fused", 2, map_backend="fused")
    jeng, _, _ = drive("jax", "host", 2)
    row = jeng.snapshot_stream(1)
    assert fused.restore_stream(0, row) is True
    got = fused.snapshot_stream(0)
    assert_same_state(got, row)
    assert_same_state(fused.snapshot_stream(1), host.snapshot_stream(1))
    bad = dict(row)
    bad["version"] = np.asarray(99, np.int32)
    assert fused.restore_stream(0, bad) is False
    small, _, _ = drive("port", "host", 1, ticks=2, loop_max_submaps=4)
    assert small.restore_stream(0, row) is False        # geometry
    assert small.restore(host.snapshot()) is False
    with pytest.raises(IndexError):
        fused.snapshot_stream(2)
    assert fused.restore(None) is False and int(fused.snapshot()["count"].sum()) == 0


def test_observe_before_a_mapper_tick_raises():
    fe = DriftingFrontEnd(params("port"), 1, SMOKE["beams"], 4)
    eng = tloop.LoopClosureEngine(params("port"), fe)
    with pytest.raises(RuntimeError, match="before any mapper tick"):
        eng.observe([None])
    with pytest.raises(ValueError, match="expected 1 estimates"):
        eng.observe([None, None])
