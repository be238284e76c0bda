"""The PyTorch package's fused device ingest against the JAX package, bit for
bit, on the CPU: the single-stream step, the fleet step, the super-step,
the engines (FusedIngest, FleetFusedIngest), ``replay_raw_fused`` and the
``replay --fused`` CLI line.

The same seeded wire streams (the JAX suite's ``_make_stream`` and a
drifting dense-capsule room) and the same staging planes go through both
packages.  Tolerances: every int32 plane, range, intensity, mask and voxel
grid exact; ``points_xy`` and ``recon_pts`` xy within 2 ulp (the port's
host-built trig table, ROADMAP C.1); stamps within 1 ulp at their
magnitude (XLA's fused multiply-add, see ``_stamps_close``).  The
de-skew arms run the JAX package's ``xla`` arm and the port's plain
versions of B4/B5 (what ``pallas`` runs for a CPU tensor).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver import ingest as jdi
from rplidar_ros2_driver_tpu.ops import deskew as jd
from rplidar_ros2_driver_tpu.ops import ingest as ji
from rplidar_ros2_driver_tpu.ops import wire as jwire
from rplidar_ros2_driver_tpu.ops.filters import FilterConfig as JFilterConfig
from rplidar_ros2_driver_tpu.protocol import crc as jcrc
from rplidar_ros2_driver_tpu.protocol import timing as jtiming
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver import ingest as tdi
from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain
from rplidar_ros2_driver_tpu_torch.ops import deskew as td
from rplidar_ros2_driver_tpu_torch.ops import ingest as ti
from rplidar_ros2_driver_tpu_torch.ops.deskew_ref import DeskewHostTwin
from rplidar_ros2_driver_tpu_torch.ops.filters import FilterConfig as TFilterConfig
from rplidar_ros2_driver_tpu_torch.protocol import timing as ttiming
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

from test_live_decode import _make_stream, _rng
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ALL_FORMATS = [int(a) for a in sorted(ttiming.SAMPLES_PER_FRAME, key=int)]
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
HQ = int(Ans.MEASUREMENT_HQ)
BEAMS = 256
RUN = 4
DSK = dict(recon_beams=BEAMS, profile_beams=64, shift_window=4, recon_window=3)
# the port's CPU median lowering is the plain sort, JAX's xla arm the same
FILTER = dict(window=4, beams=BEAMS, grid=32, median_backend="xla")


def _filters():
    return JFilterConfig(**FILTER), TFilterConfig(**FILTER)


def _deskews(on: bool):
    return (jd.DeskewConfig(**DSK), td.DeskewConfig(**DSK)) if on else (None, None)


def _params(pkg, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"),
                filter_window=4, voxel_grid_size=32, median_backend="xla")
    base.update(over)
    return (JParams if pkg == "jax" else TParams)(**base)


def _dense_frames(revs: int, ppr: int = 400, drift_per_rev: float = 0.0, seed: int = 0):
    """A drifting dense-capsule room (tests/test_deskew.py's scene)."""
    rng = np.random.default_rng(seed)
    frames, idx, first = [], 0, True
    while idx < revs * ppr:
        pts = (np.arange(40) + idx) % ppr
        dists = (2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr) + drift_per_rev * (idx / ppr)
                 + rng.uniform(0.0, 0.25))
        frames.append(jwire.encode_dense_capsule(
            int(360.0 * (idx % ppr) / ppr * 64) & 0x7FFF, first, dists.astype(int)))
        idx += 40
        first = False
    return frames


def _ulp_close(got, want, ulps):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    spacing = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return bool(np.all(np.abs(got - want) <= ulps * spacing))


def _stamps_close(got, want):
    """Stamps within 1 ulp at the plane's magnitude: XLA fuses ``first +
    step·i`` into one rounding where it chooses to (the port rounds once
    everywhere), and a stamp re-based across steps keeps the absolute
    difference, not the relative one."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if got.size == 0:
        return got.shape == want.shape
    scale = np.spacing(np.float32(max(np.abs(got).max(), np.abs(want).max())))
    return bool(np.all(np.abs(got - want) <= scale))


def _assert_output_equal(j, t, what):
    for field in ("ranges", "intensities", "point_mask", "voxel"):
        np.testing.assert_array_equal(np.asarray(t[field] if isinstance(t, dict) else
                                                 getattr(t, field)),
                                      np.asarray(getattr(j, field)), err_msg=f"{what} {field}")
    assert _ulp_close(np.asarray(t.points_xy), np.asarray(j.points_xy), 2), f"{what} points_xy"


def _assert_result_equal(j, t, what=""):
    """One stream's IngestBatchResult of each package."""
    for f in ("n_completed", "revs_dropped", "syncs", "nodes_appended", "recon_pushed",
              "recon_valid"):
        assert getattr(t, f) == getattr(j, f), f"{what} {f}"
    np.testing.assert_array_equal(t.counts, j.counts, err_msg=what)
    assert _stamps_close(t.ts0, j.ts0) and _stamps_close(t.end_ts, j.end_ts), what
    for k, (jo, to) in enumerate(zip(j.outputs, t.outputs)):
        _assert_output_equal(jo, to, f"{what} rev {k}")
    for f in ("nodes", "recon_plane", "deskew_motion"):
        jv, tv = getattr(j, f), getattr(t, f)
        assert (jv is None) == (tv is None), f"{what} {f}"
        if jv is not None:
            np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=f"{what} {f}")
    if j.node_ts is not None:
        assert _stamps_close(t.node_ts, j.node_ts), what
    if j.recon_pts is not None:
        np.testing.assert_array_equal(t.recon_pts[:, 2], np.asarray(j.recon_pts)[:, 2])
        assert _ulp_close(t.recon_pts[:, :2], np.asarray(j.recon_pts)[:, :2], 2), what


def _assert_filter_equal(jfilter, tfilter, lane=None):
    for k in ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled"):
        j = np.asarray(getattr(jfilter, k))
        j = j if lane is None else j[lane]
        t = getattr(tfilter, k).numpy()
        t = t if lane is None else t[lane]
        np.testing.assert_array_equal(t, j, err_msg=k)


# ---------------------------------------------------------------------------
# the single-stream step
# ---------------------------------------------------------------------------


def _single_batches(ans, frames, chunk_seed=5, t0=100.0, run=RUN):
    """(buf, aux) staging planes of the single-stream step, random chunk
    sizes 1..run, the JAX suite's stamp pacing."""
    rng = np.random.default_rng(chunk_seed)
    fb = len(frames[0])
    out, t, prev_base, i = [], t0, None, 0
    while i < len(frames):
        k = int(rng.integers(1, run + 1))
        chunk = frames[i : i + k]
        m = len(chunk)
        stamps = [t + 0.002 * (n + 1) for n in range(m)]
        t = stamps[-1]
        base = stamps[0]
        buf = np.zeros((run, fb), np.uint8)
        buf[:m] = np.frombuffer(b"".join(chunk), np.uint8).reshape(m, fb)
        aux = np.zeros((2 * run + 2,), np.float32)
        aux[:m] = [s - base for s in stamps]
        if ans == HQ:
            aux[run : run + m] = [float(jcrc.frame_crc_ok(f)) for f in chunk]
        aux[-2] = 0.0 if prev_base is None else prev_base - base
        aux[-1] = m
        prev_base = base
        out.append((buf, aux))
        i += k
    return out


def _run_single(ans, frames, *, deskew, max_revs=2, max_nodes=1024, chunk_seed=5, run=RUN):
    """Both packages' single-stream steps over the same planes; results
    compared step by step.  Returns (jax state, port state, steps)."""
    jf, tf = _filters()
    jdsk, tdsk = _deskews(deskew)
    kw = dict(max_nodes=max_nodes, max_revs=max_revs, emit_nodes=True)
    jcfg = ji.ingest_config_for(ans, jtiming.TimingDesc(), jf, deskew=jdsk, **kw)
    tcfg = ti.ingest_config_for(ans, ttiming.TimingDesc(), tf, deskew=tdsk, **kw)
    js, ts = ji.create_ingest_state(jcfg), ti.create_ingest_state(tcfg)
    steps = []
    for n, (buf, aux) in enumerate(_single_batches(ans, frames, chunk_seed, run=run)):
        js, *jr = ji.fused_ingest_step(js, buf, aux, cfg=jcfg)
        ts, *tr = ti.fused_ingest_step(ts, torch.from_numpy(buf), aux, tcfg)
        jres, tres = ji.unpack_ingest_result(jr, jcfg), ti.unpack_ingest_result(tr, tcfg)
        _assert_result_equal(jres, tres, f"step {n}")
        steps.append(tres)
    _assert_filter_equal(js.filter, ts.filter)
    for k in ("partial", "partial_len", "seen_sync", "sync_carry", "dist_carry", "prev_frame",
              "have_prev", "scans_completed", "revs_dropped", "recon_ring", "recon_pos",
              "deskew_prof", "deskew_motion"):
        j = getattr(js, k)
        assert (j is None) == (getattr(ts, k) is None), k
        if j is not None:
            np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(j), err_msg=k)
    return js, ts, steps


@pytest.mark.parametrize("ans", ALL_FORMATS, ids=lambda a: f"{a:#x}")
def test_single_step_all_formats(ans):
    frames = _make_stream(ans, 60, _rng(), syncs=(0, 15, 30, 45))
    _js, ts, steps = _run_single(ans, frames, deskew=False)
    assert sum(s.n_completed for s in steps) >= 2


@pytest.mark.parametrize("ans", [DENSE, int(Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED), HQ,
                                 int(Ans.MEASUREMENT)], ids=lambda a: f"{a:#x}")
def test_single_step_deskew(ans):
    frames = _make_stream(ans, 60, _rng(), syncs=(0, 15, 30, 45))
    _js, _ts, steps = _run_single(ans, frames, deskew=True)
    assert sum(s.n_completed for s in steps) >= 2
    assert any(s.recon_pushed for s in steps)


def test_single_step_deskew_drifting_scene_moves():
    _js, ts, steps = _run_single(DENSE, _dense_frames(5, drift_per_rev=60.0), deskew=True)
    assert (ts.deskew_motion != 0).any()
    assert sum(s.n_completed for s in steps) >= 3


@pytest.mark.parametrize("ans", [DENSE, HQ], ids=lambda a: f"{a:#x}")
def test_single_step_checksum_and_crc_faults(ans):
    frames = list(_make_stream(ans, 40, _rng(), syncs=(0, 10, 20, 30), corrupt=(7, 8, 23)))
    if ans == HQ:
        for k in (5, 13):  # a flipped payload byte fails CRC32 on both paths
            fr = bytearray(frames[k])
            fr[40] ^= 0xFF
            frames[k] = bytes(fr)
    _run_single(ans, frames, deskew=True)


def test_single_step_max_revs_overflow_drops_oldest():
    ans = int(Ans.MEASUREMENT)
    frames = _make_stream(ans, 60, _rng(), syncs=tuple(range(0, 60, 4)))
    _js, ts, steps = _run_single(ans, frames, deskew=True, max_revs=1, run=16)
    assert sum(s.revs_dropped for s in steps) > 0 and int(ts.revs_dropped) > 0


def test_zero_revolution_step_leaves_filter_state_unchanged():
    """A step that completes no revolution runs no filter step: every
    FilterState plane stays byte-equal."""
    jf, tf = _filters()
    frames = _make_stream(DENSE, 40, _rng(), syncs=(0, 20))
    tcfg = ti.ingest_config_for(DENSE, ttiming.TimingDesc(), tf, max_nodes=1024,
                                deskew=td.DeskewConfig(**DSK))
    ts = ti.create_ingest_state(tcfg)
    idle_steps = 0
    for buf, aux in _single_batches(DENSE, frames):
        before = ts.filter.to_numpy()
        ts, meta, *_ = ti.fused_ingest_step(ts, torch.from_numpy(buf), aux, tcfg)
        if meta[0] == 0:
            idle_steps += 1
            after = ts.filter.to_numpy()
            for k in before:
                np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert idle_steps > 5 and int(ts.scans_completed) >= 1


# ---------------------------------------------------------------------------
# the fleet step and the super-step
# ---------------------------------------------------------------------------


def _fleet_planes(streams_fmts, n_ticks, *, switch=None, idle=(), run=RUN, seed=3):
    """Per-tick (buf, aux) fleet planes: stream s streams format
    ``streams_fmts[s]`` (``switch=(s, tick, fmt)`` changes one stream's
    format mid-run, with the decode-reset flag), idle on ticks in ``idle``
    (pairs (s, tick)).  Returns (formats, ticks)."""
    rng = np.random.default_rng(seed)
    fmts = list(streams_fmts)
    formats = tuple(dict.fromkeys(fmts + ([switch[2]] if switch else [])))
    fb = max(len(_make_stream(f, 1, _rng())[0]) for f in formats)
    streams = {}
    for s, f in enumerate(fmts):
        streams[(s, f)] = list(_make_stream(f, 4 * n_ticks, np.random.default_rng(s),
                                            syncs=tuple(range(0, 4 * n_ticks, 9))))
    if switch:
        s, _t, f = switch
        streams[(s, f)] = list(_make_stream(f, 4 * n_ticks, np.random.default_rng(50),
                                            syncs=tuple(range(0, 4 * n_ticks, 5))))
    cursor = {k: 0 for k in streams}
    clock = [100.0 + 5 * s for s in range(len(fmts))]
    bases = [None] * len(fmts)
    ticks = []
    for t in range(n_ticks):
        buf = np.zeros((len(fmts), run, fb), np.uint8)
        aux = np.zeros((len(fmts), ti.fleet_aux_len(run)), np.float32)
        for s in range(len(fmts)):
            if switch and switch[0] == s and t == switch[1]:
                fmts[s] = switch[2]
                aux[s, 2 * run + 3] = 1.0
                bases[s] = None
            f = fmts[s]
            aux[s, 2 * run + 2] = formats.index(f)
            if (s, t) in idle:
                continue
            m = int(rng.integers(2, run + 1))
            chunk = streams[(s, f)][cursor[(s, f)] : cursor[(s, f)] + m]
            cursor[(s, f)] += m
            stamps = [clock[s] + 0.002 * (n + 1) for n in range(m)]
            clock[s] = stamps[-1]
            w = len(chunk[0])
            buf[s, :m, :w] = np.frombuffer(b"".join(chunk), np.uint8).reshape(m, w)
            aux[s, :m] = [x - stamps[0] for x in stamps]
            if f == HQ:
                aux[s, run : run + m] = [float(jcrc.frame_crc_ok(fr)) for fr in chunk]
            aux[s, 2 * run] = 0.0 if bases[s] is None else bases[s] - stamps[0]
            aux[s, 2 * run + 1] = m
            bases[s] = stamps[0]
        ticks.append((buf, aux))
    return formats, ticks


def _fleet_cfgs(formats, deskew=True, max_revs=2):
    jf, tf = _filters()
    jdsk, tdsk = _deskews(deskew)
    kw = dict(max_nodes=1024, max_revs=max_revs, emit_nodes=True)
    return (ji.fleet_ingest_config_for(formats, jtiming.TimingDesc(), jf, deskew=jdsk, **kw),
            ti.fleet_ingest_config_for(formats, ttiming.TimingDesc(), tf, deskew=tdsk, **kw))


def _assert_fleet_state_equal(js, ts):
    for lane in range(ts.partial.shape[0]):
        _assert_filter_equal(js.filter, ts.filter, lane)
    for k in ("partial", "partial_len", "seen_sync", "sync_carry", "dist_carry", "prev_frame",
              "have_prev", "scans_completed", "revs_dropped", "recon_ring", "recon_pos",
              "deskew_prof", "deskew_motion"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(), np.asarray(getattr(js, k)),
                                      err_msg=k)


@pytest.mark.parametrize("streams", [1, 3])
def test_fleet_step_matches_jax(streams):
    """Mixed formats, idle lanes and a mid-run format switch (decode reset)
    through both packages' fleet steps, tick by tick."""
    if streams == 1:
        formats, ticks = _fleet_planes([DENSE], 16)
    else:
        formats, ticks = _fleet_planes([DENSE, HQ, int(Ans.MEASUREMENT_CAPSULED)], 16,
                                       switch=(1, 8, int(Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED)),
                                       idle={(2, 3), (2, 4), (0, 7)})
    jcfg, tcfg = _fleet_cfgs(formats)
    js = ji.create_fleet_ingest_state(jcfg, streams)
    ts = ti.create_fleet_ingest_state(tcfg, streams)
    done = 0
    for n, (buf, aux) in enumerate(ticks):
        js, *jr = ji.fleet_fused_ingest_step(js, buf, aux, cfg=jcfg)
        ts, *tr = ti.fleet_fused_ingest_step(ts, torch.from_numpy(buf), aux, tcfg)
        for s, (j, t) in enumerate(zip(ji.unpack_fleet_ingest_result(jr, jcfg),
                                       ti.unpack_fleet_ingest_result(tr, tcfg))):
            _assert_result_equal(j, t, f"tick {n} stream {s}")
            done += t.n_completed
    _assert_fleet_state_equal(js, ts)
    assert done >= 2 * streams


@pytest.mark.parametrize("T", [1, 2, 8])
def test_super_step_matches_jax_and_per_tick(T):
    formats, ticks = _fleet_planes([DENSE, HQ], 8, idle={(1, 2)})
    jcfg, tcfg = _fleet_cfgs(formats)
    n_pad = -(-len(ticks) // T) * T
    bufs = np.stack([b for b, _ in ticks] + [np.zeros_like(ticks[0][0])] * (n_pad - len(ticks)))
    auxs = np.stack([a for _, a in ticks] + [np.zeros_like(ticks[0][1])] * (n_pad - len(ticks)))
    js = ji.create_fleet_ingest_state(jcfg, 2)
    ts = ti.create_fleet_ingest_state(tcfg, 2)
    seq = ti.create_fleet_ingest_state(tcfg, 2)
    for g in range(0, n_pad, T):
        js, *jr = ji.super_fleet_ingest_step(js, bufs[g : g + T], auxs[g : g + T], cfg=jcfg)
        ts, *tr = ti.super_fleet_ingest_step(ts, torch.from_numpy(bufs[g : g + T]),
                                             auxs[g : g + T], tcfg)
        jt = ji.unpack_super_fleet_ingest_result(jr, jcfg)
        tt = ti.unpack_super_fleet_ingest_result(tr, tcfg)
        for k in range(T):
            seq, *sr = ti.fleet_fused_ingest_step(seq, torch.from_numpy(bufs[g + k]),
                                                  auxs[g + k], tcfg)
            for s, (j, t, q) in enumerate(zip(jt[k], tt[k],
                                              ti.unpack_fleet_ingest_result(sr, tcfg))):
                _assert_result_equal(j, t, f"tick {g + k} stream {s}")
                _assert_result_equal(t, q, f"per-tick {g + k} stream {s}")
    _assert_fleet_state_equal(js, ts)
    _assert_fleet_state_equal(js, seq)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _items(frames, run=RUN, t0=100.0):
    t, out = t0, []
    for i in range(0, len(frames), run):
        batch = []
        for f in frames[i : i + run]:
            t += 0.00125
            batch.append((f, t))
        out.append(batch)
    return out


def test_fused_ingest_matches_deskew_host_twin_and_jax():
    """FusedIngest on a drifting scene against DeskewHostTwin + the port's
    chain (recon planes and de-skewed revolutions) and against the JAX
    engine (outputs and timestamps)."""
    over = dict(ingest_backend="fused", deskew_enable=True, sweep_reconstruct_window=3,
                deskew_profile_beams=64, deskew_shift_window=4)
    tparams, jparams = _params("torch", **over), _params("jax", **over)
    frames = _dense_frames(6, drift_per_rev=60.0)
    eng = tdi.FusedIngest(tparams, beams=BEAMS, capacity=1024, max_revs=2, buckets=(RUN,))
    jeng = jdi.FusedIngest(jparams, beams=BEAMS, capacity=1024, max_revs=2, buckets=(RUN,))
    eng.recon_log = jeng.recon_log = True
    twin = DeskewHostTwin(td.deskew_config_from_params(tparams, BEAMS, "cpu"), max_nodes=1024)
    chain = ScanFilterChain(tparams, beams=BEAMS, warmup=False)
    twin_recons, twin_outs = [], []
    for items in _items(frames):
        eng.on_measurement_batch(DENSE, list(items))
        jeng.on_measurement_batch(DENSE, list(items))
        combined, pushed, revs = twin.tick(DENSE, items)
        if pushed:
            twin_recons.append(combined)
        for a2, d2, scan in revs:
            twin_outs.append(chain.process_raw(a2, d2, scan["quality"], scan["flag"]))
    outs, jouts = eng.flush(), jeng.flush()
    assert len(eng.recon_history) == len(twin_recons) == len(jeng.recon_history) > 0
    for (plane, pts), tw, (jplane, _jpts) in zip(eng.recon_history, twin_recons,
                                                 jeng.recon_history):
        np.testing.assert_array_equal(plane, tw)
        np.testing.assert_array_equal(plane, np.asarray(jplane))
        assert pts.shape == (BEAMS, 3)
    assert len(outs) == len(twin_outs) == len(jouts) > 0
    for k, ((out, ts0, dur), tw, (jout, jts0, jdur)) in enumerate(zip(outs, twin_outs, jouts)):
        np.testing.assert_array_equal(out.ranges, tw.ranges, err_msg=f"rev {k}")
        _assert_output_equal(jout, out, f"rev {k}")
        assert ts0 == jts0 and abs(dur - jdur) < 1e-6
    assert (twin.stream.motion != 0).any()
    assert eng.scans_completed == jeng.scans_completed


def test_fused_ingest_format_switch_and_reset_match_jax():
    """A scan-mode change resets decode state and carries the filter
    window; reset() drops the partial revolution — both engines agree."""
    tparams, jparams = _params("torch"), _params("jax")
    eng = tdi.FusedIngest(tparams, beams=BEAMS, max_revs=6, buckets=(RUN,))
    jeng = jdi.FusedIngest(jparams, beams=BEAMS, max_revs=6, buckets=(RUN,))
    a1, a2 = DENSE, HQ
    f1 = _make_stream(a1, 40, _rng(), syncs=(0,))
    f2 = _make_stream(a2, 30, _rng(), syncs=(0, 8, 16, 24))
    t0 = 100.0
    outs, jouts = [], []
    for ans, frames in ((a1, f1), (a2, f2), (a1, f1[:30])):
        for items in _items(frames, t0=t0):
            for e in (eng, jeng):
                e.on_measurement_batch(ans, list(items))
        t0 += 10.0
        if ans == a2:
            # a reset drops the partial revolution (and unparsed results)
            outs, jouts = outs + eng.flush(), jouts + jeng.flush()
            for e in (eng, jeng):
                e.reset()
    outs, jouts = outs + eng.flush(), jouts + jeng.flush()
    assert len(outs) == len(jouts) >= 5
    for k, ((o, ts0, _d), (j, jts0, _jd)) in enumerate(zip(outs, jouts)):
        _assert_output_equal(j, o, f"rev {k}")
        assert ts0 == jts0
    _assert_filter_equal(jeng._state.filter, eng._state.filter)


def test_fleet_engine_backlog_matches_jax():
    """FleetFusedIngest.submit_backlog (super-steps of 2, an oversized tick
    split across slices, an idle stream tick) against the JAX engine."""
    over = dict(deskew_enable=True, sweep_reconstruct_window=3, deskew_profile_beams=64,
                deskew_shift_window=4, super_tick_max=2)
    frames = _dense_frames(3, drift_per_rev=40.0)
    hq = _make_stream(HQ, 30, _rng(), syncs=(0, 8, 16, 24))
    ticks = []
    d_items, h_items = _items(frames), _items(hq, t0=300.0)
    for k in range(max(len(d_items), len(h_items))):
        tick = [(DENSE, d_items[k]) if k < len(d_items) else None,
                (HQ, h_items[k]) if k < len(h_items) and k != 3 else None]
        ticks.append(tick)
    ticks[2] = [(DENSE, d_items[2] + d_items[2][:0]), (HQ, h_items[2] + h_items[3])]
    eng = tdi.FleetFusedIngest(_params("torch", **over), 2, beams=BEAMS, capacity=1024,
                               max_revs=2, buckets=(RUN,))
    jeng = jdi.FleetFusedIngest(_params("jax", **over), 2, beams=BEAMS, capacity=1024,
                                max_revs=2, buckets=(RUN,))
    eng.recon_log = jeng.recon_log = True
    outs, jouts = eng.submit_backlog(ticks), jeng.submit_backlog(ticks)
    assert eng.dispatch_count == jeng.dispatch_count and eng.ticks == jeng.ticks
    assert eng.super_dispatches == jeng.super_dispatches > 0
    for s in range(2):
        assert len(outs[s]) == len(jouts[s]) > 0
        for k, ((o, ts0, _d), (j, jts0, _jd)) in enumerate(zip(outs[s], jouts[s])):
            _assert_output_equal(j, o, f"stream {s} rev {k}")
            assert ts0 == jts0
        assert len(eng.recon_history[s]) == len(jeng.recon_history[s])
        for (p, _pts), (jp, _jpts) in zip(eng.recon_history[s], jeng.recon_history[s]):
            np.testing.assert_array_equal(p, np.asarray(jp))
        _assert_filter_equal(jeng._state.filter, eng._state.filter, s)
    assert eng.take_recon()[0] is not None and eng.take_recon() == [None, None]


def test_unported_surfaces_raise_naming_their_roadmap_items():
    # the carried map (A.7b) is ported: it needs the de-skew stage, and an
    # engine without the fused mapping route carries no map
    _jf, tf = _filters()
    with pytest.raises(ValueError, match="de-skew"):
        ti.ingest_config_for(DENSE, ttiming.TimingDesc(), tf, mapping=object())
    eng = tdi.FleetFusedIngest(_params("torch"), 2, beams=BEAMS)
    with pytest.raises(RuntimeError, match="carries no map"):
        eng.map_snapshot()
    # the serving pod's cold reset is ported (ROADMAP A.10a): it needs the
    # template captured before traffic
    with pytest.raises(RuntimeError, match="capture_cold_template"):
        eng.cold_reset()


# ---------------------------------------------------------------------------
# replay_raw_fused and the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    from rplidar_ros2_driver_tpu_torch.replay import FrameRecorder

    path = str(tmp_path_factory.mktemp("cap") / "drift.rplr")
    with FrameRecorder(path) as rec:
        for i, fr in enumerate(_dense_frames(8, drift_per_rev=50.0)):
            rec.write(DENSE, fr, 10.0 + i * 1e-3)
    return path


@pytest.mark.parametrize("deskew", [False, True])
def test_replay_raw_fused_matches_jax(capture, deskew):
    from rplidar_ros2_driver_tpu.replay import replay_raw_fused as jreplay
    from rplidar_ros2_driver_tpu_torch.replay import (
        decode_recording,
        replay_raw_fused,
        replay_through_chain,
    )

    over = dict(deskew_enable=deskew, deskew_profile_beams=64, deskew_shift_window=4)
    kw = dict(beams=BEAMS, capacity=1024, frames_per_tick=16, super_ticks=4, max_revs=4)
    ranges, state, stats = replay_raw_fused(capture, _params("torch", **over), **kw)
    jranges, jstate, jstats = jreplay(capture, _params("jax", **over), **kw)
    np.testing.assert_array_equal(ranges, jranges)
    _assert_filter_equal(jstate, state)
    for k in ("ticks", "dispatches", "super_dispatches", "frames", "scans"):
        assert stats[k] == jstats[k], k
    assert stats["scans"] >= 6
    if deskew:
        assert len(stats["recon_history"]) == len(jstats["recon_history"]) > 0
        for (p, _pts), (jp, _jpts) in zip(stats["recon_history"], jstats["recon_history"]):
            np.testing.assert_array_equal(p, np.asarray(jp))
    else:
        revs = decode_recording(capture, device="cpu").revolutions()
        hranges, hstate = replay_through_chain(revs, _params("torch"), beams=BEAMS,
                                               capacity=1024)
        np.testing.assert_array_equal(ranges, hranges)
        np.testing.assert_array_equal(state.voxel_acc.numpy(), hstate.voxel_acc.numpy())
    with pytest.raises(ValueError, match="dropped"):
        replay_raw_fused(capture, _params("torch", **over), **{**kw, "max_revs": 1,
                                                                "frames_per_tick": 64})


def test_cli_replay_fused_line_matches_jax(capture, capsys):
    from rplidar_ros2_driver_tpu.__main__ import main as jmain
    from rplidar_ros2_driver_tpu_torch.__main__ import main as tmain

    def fused_line(main):
        assert main(["replay", capture, "--fused", "--cpu"]) == 0
        lines = [ln for ln in capsys.readouterr().out.splitlines() if "fused raw replay" in ln]
        assert len(lines) == 1
        # the times differ run to run; everything else must agree
        return re.sub(r"\d+\.\d+ s|\(\d+ scans/s", "<t>", lines[0])

    got, want = fused_line(tmain), fused_line(jmain)
    assert got == want and "parity OK" in got
