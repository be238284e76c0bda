"""The PyTorch package's filter step against the JAX package's, on the CPU.

Inputs come from seeded numpy and go through both packages.  Everything is
held bit-exact except ``points_xy``, which is held to 2 ulp: the port takes
cos/sin from a float64 table rounded to float32 (so its CPU and CUDA arms
agree bit for bit), while JAX evaluates float32 trig, which is itself an
ulp off the correctly rounded value on some angles.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.types import ScanBatch as JScanBatch
from rplidar_ros2_driver_tpu.ops import filters as jf
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch as TScanBatch
from rplidar_ros2_driver_tpu_torch.ops import filters as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CPU = torch.device("cpu")
# small geometry: W=8, B=256, grid 64
W, B, G = 8, 256, 64
# JAX's median formulations compiled whole, as its filter step runs them:
# one XLA program a shape, not one a primitive and shape (sorts, counts and
# selections: the same values as an eager call)
jtemporal_median = jax.jit(jf.temporal_median)
jrecompute_median_sorted = jax.jit(jf.recompute_median_sorted)
jmedian_from_sorted = jax.jit(jf.median_from_sorted)
jsorted_replace = jax.jit(jf.sorted_replace)


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 units in the last place."""

    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def assert_xy_close(jax_xy, torch_xy) -> None:
    # 2 ulp: the port's trig table is correctly rounded, JAX's f32
    # cos/sin may be one ulp off it, and the product rounds once more
    assert ulp_distance(np.asarray(jax_xy), np.asarray(torch_xy)).max() <= 2


def rand_scan(rng, n: int = 300, dist_hi: int = 180_000) -> dict:
    """A ragged revolution: random angles (some beyond a full Q14 turn),
    drop-outs (dist 0), out-of-range points, random quality."""
    angle = rng.integers(0, 1 << 16, n).astype(np.int32)
    dist = rng.integers(0, dist_hi, n).astype(np.int32)
    dist[rng.random(n) < 0.1] = 0
    qual = rng.integers(0, 256, n).astype(np.int32)
    flag = rng.integers(0, 4, n).astype(np.int32)
    return {"angle_q14": angle, "dist_q2": dist, "quality": qual, "flag": flag}


def batches(scan, n: int = 512):
    args = (scan["angle_q14"], scan["dist_q2"], scan["quality"], scan["flag"], n)
    return JScanBatch.from_numpy(*args), TScanBatch.from_numpy(*args, device=CPU)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_clip_filter_matches():
    rng = np.random.default_rng(0)
    cfg = jf.FilterConfig(range_min_m=0.5, range_max_m=20.0, intensity_min=30.0)
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    for _ in range(5):
        jb, tb = batches(rand_scan(rng))
        np.testing.assert_array_equal(
            np_(jf.clip_filter(jb, cfg).dist_q2), np_(tf.clip_filter(tb, tcfg).dist_q2)
        )


@pytest.mark.parametrize("with_cfg", [False, True])
def test_resample_keys_and_both_resamplers(with_cfg):
    rng = np.random.default_rng(1)
    cfg = jf.FilterConfig(window=W, beams=B, grid=G, range_max_m=30.0)
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    for _ in range(5):
        jb, tb = batches(rand_scan(rng))
        jbeam, jpk = jf._resample_keys(jb, B, cfg if with_cfg else None)
        tbeam, tpk = tf._resample_keys(tb, B, tcfg if with_cfg else None)
        np.testing.assert_array_equal(np_(jbeam), np_(tbeam))
        np.testing.assert_array_equal(np_(jpk), np_(tpk))
        jr, ji = jf.grid_resample(jb, B, cfg if with_cfg else None)
        tr, ti = tf.grid_resample(tb, B, tcfg if with_cfg else None)
        np.testing.assert_array_equal(np_(jr), np_(tr))
        np.testing.assert_array_equal(np_(ji), np_(ti))
        dr, di = tf.grid_resample_batch(tbeam[None], tpk[None], B)
        np.testing.assert_array_equal(np_(dr[0]), np_(tr))
        np.testing.assert_array_equal(np_(di[0]), np_(ti))


def test_grid_resample_batch_and_decode_match():
    rng = np.random.default_rng(2)
    k, p = 3, 400
    beam = rng.integers(0, B, (k, p)).astype(np.int32)
    packed = rng.integers(0, 1 << 26, (k, p)).astype(np.int32)
    packed[rng.random((k, p)) < 0.3] = 0x7FFFFFFF
    jr, ji = jf.grid_resample_batch(jnp.asarray(beam), jnp.asarray(packed), B)
    tr, ti = tf.grid_resample_batch(torch.from_numpy(beam), torch.from_numpy(packed), B)
    np.testing.assert_array_equal(np_(jr), np_(tr))
    np.testing.assert_array_equal(np_(ji), np_(ti))


def rand_window(rng, w, b, inf_frac=0.3, ties=False):
    win = rng.uniform(0.1, 40.0, (w, b)).astype(np.float32)
    if ties:
        win = (np.round(win * 1000.0) / 1000.0).astype(np.float32)
        win = np.round(win, 0).astype(np.float32)  # heavy ties
    win[rng.random((w, b)) < inf_frac] = np.inf
    win[:, 0] = np.inf  # an all-missing beam stays +inf
    return win


@pytest.mark.parametrize("w,b,ties", [(1, 5, False), (7, 100, True), (8, 256, False), (33, 257, True)])
def test_median_functions_match(w, b, ties):
    rng = np.random.default_rng(w * 31 + b)
    win = rand_window(rng, w, b, ties=ties)
    np.testing.assert_array_equal(
        np_(jtemporal_median(jnp.asarray(win))),
        np_(tf.temporal_median(torch.from_numpy(win))),
    )
    s = np.sort(win, axis=0)
    np.testing.assert_array_equal(
        np_(jrecompute_median_sorted(win)), np_(tf.recompute_median_sorted(torch.from_numpy(win)))
    )
    np.testing.assert_array_equal(
        np_(jmedian_from_sorted(jnp.asarray(s))),
        np_(tf.median_from_sorted(torch.from_numpy(s))),
    )
    old = win[min(3, w - 1)].copy()
    new = rng.uniform(0.1, 40.0, b).astype(np.float32)
    new[rng.random(b) < 0.3] = np.inf
    if ties:
        new = np.round(new, 0).astype(np.float32)
    np.testing.assert_array_equal(
        np_(jsorted_replace(jnp.asarray(s), jnp.asarray(old), jnp.asarray(new))),
        np_(tf.sorted_replace(torch.from_numpy(s), torch.from_numpy(old), torch.from_numpy(new))),
    )


@pytest.fixture(scope="module")
def jax_inc_median() -> list:
    """JAX's jnp formulation of the incremental median over 3 W ring
    steps, once per module: per step the ring (before the step), the
    cursor, the new row and JAX's (sorted window, median)."""
    rng = np.random.default_rng(5)
    ring = np.full((W, B), np.inf, np.float32)
    sor = ring.copy()
    steps = []
    for step in range(3 * W):
        new = rng.uniform(0.1, 40.0, B).astype(np.float32)
        new[rng.random(B) < 0.3] = np.inf
        if step % 5 == 0:
            new[:] = new[1]
        cur = step % W
        jms, jmed = jf.inc_median(
            jnp.asarray(ring), jnp.asarray(cur, jnp.int32), jnp.asarray(sor),
            jnp.asarray(new), backend="inc_xla",
        )
        steps.append((ring.copy(), cur, new, np.asarray(jms), np.asarray(jmed)))
        sor = np.asarray(jms)
        ring[cur] = new
    return steps


@pytest.mark.parametrize("backend", ["inc", "inc_xla", "inc_pallas"])
def test_inc_median_matches(backend, jax_inc_median):
    """The port's inc lowerings on the CPU (inc_pallas goes through the B2
    wrapper, which takes its plain version for a CPU tensor) against the
    JAX package's jnp formulation (one JAX run for the three lowerings)."""
    tsor = torch.from_numpy(np.full((W, B), np.inf, np.float32))
    for ring, cur, new, jms, jmed in jax_inc_median:
        tms, tmed = tf.inc_median(
            torch.from_numpy(ring.copy()), torch.tensor(cur, dtype=torch.int32), tsor,
            torch.from_numpy(new.copy()), backend=backend,
        )
        np.testing.assert_array_equal(jms, np_(tms))
        np.testing.assert_array_equal(jmed, np_(tmed))
        tsor = tms


def test_inc_median_requires_sorted_state_and_pins_lowering():
    with pytest.raises(ValueError):
        tf.inc_median(torch.zeros(2, 3), torch.tensor(0, dtype=torch.int32), None, torch.zeros(3))
    assert tf.pin_inc_lowering("inc", "cuda") == "inc_pallas"
    assert tf.pin_inc_lowering("inc", "cpu") == "inc_xla"
    assert tf.pin_inc_lowering("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError):
        tf.pin_inc_lowering("inc", "mps")


@pytest.mark.parametrize("beams", [256, 2048, 1000])
def test_polar_to_cartesian_within_two_ulp(beams):
    rng = np.random.default_rng(beams)
    r = rng.uniform(0.1, 40.0, beams).astype(np.float32)
    r[rng.random(beams) < 0.3] = np.inf
    jxy, jm = jf.polar_to_cartesian(jnp.asarray(r), beams)
    txy, tm = tf.polar_to_cartesian(torch.from_numpy(r), beams)
    np.testing.assert_array_equal(np_(jm), np_(tm))
    assert_xy_close(jxy, txy)
    # the table is built once per (beams, device) and reused
    assert tf._trig_table(beams, CPU) is tf._trig_table(beams, CPU)


@pytest.mark.parametrize("cell_m", [0.25, 0.1])
def test_voxel_ops_match(cell_m):
    rng = np.random.default_rng(int(cell_m * 100))
    xy = rng.uniform(-6.0, 6.0, (B, 2)).astype(np.float32)
    # points on cell boundaries, where the floor of a division decides
    xy[:40] = (rng.integers(-30, 30, (40, 2)) * np.float32(cell_m)).astype(np.float32)
    mask = rng.random(B) < 0.8
    for name in ("scatter", "matmul"):
        j = jf.select_voxel_hits(name)(jnp.asarray(xy), jnp.asarray(mask), G, cell_m)
        t = tf.select_voxel_hits(name)(torch.from_numpy(xy), torch.from_numpy(mask), G, cell_m)
        np.testing.assert_array_equal(np_(j), np_(t))
    jg = jf._voxel_cells(jnp.asarray(xy), jnp.asarray(mask), G, cell_m)
    tg = tf._voxel_cells(torch.from_numpy(xy), torch.from_numpy(mask), G, cell_m)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(np_(a), np_(b))
    with pytest.raises(ValueError):
        tf.select_voxel_hits("auto")


def _compare_states(js, ts):
    for f in ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled"):
        np.testing.assert_array_equal(np_(getattr(js, f)), np_(getattr(ts, f)), err_msg=f)
    if js.median_sorted is None:
        assert ts.median_sorted is None
    else:
        np.testing.assert_array_equal(np_(js.median_sorted), np_(ts.median_sorted))


def _compare_outputs(jo, to):
    for f in ("ranges", "intensities", "point_mask", "voxel"):
        np.testing.assert_array_equal(np_(getattr(jo, f)), np_(getattr(to, f)), err_msg=f)
    assert_xy_close(jo.points_xy, to.points_xy)


@pytest.mark.parametrize("voxel", ["scatter", "matmul"])
@pytest.mark.parametrize("resample", ["scatter", "dense"])
@pytest.mark.parametrize("median", ["xla", "pallas", "inc_xla", "inc_pallas"])
def test_filter_step_trajectory_matches(median, resample, voxel):
    """More than W steps (unfilled window, then wraparound) for every
    median x resample x voxel backend."""
    cfg = jf.FilterConfig(
        window=W, beams=B, grid=G, cell_m=0.25, range_max_m=30.0,
        median_backend=median, resample_backend=resample, voxel_backend=voxel,
    )
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    js = jf.FilterState.for_config(cfg)
    ts = tf.FilterState.for_config(tcfg, device=CPU)
    rng = np.random.default_rng(7)
    for _ in range(W + 3):
        jb, tb = batches(rand_scan(rng, dist_hi=40_000))
        js, jo = jf.filter_step(js, jb, cfg)
        ts, to = tf.filter_step(ts, tb, tcfg)
        _compare_outputs(jo, to)
    _compare_states(js, ts)


def test_filter_step_with_stages_disabled():
    cfg = jf.FilterConfig(window=4, beams=B, grid=G, enable_clip=False,
                          enable_median=False, enable_voxel=False)
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    js = jf.FilterState.for_config(cfg)
    ts = tf.FilterState.for_config(tcfg, device=CPU)
    rng = np.random.default_rng(8)
    for _ in range(6):
        jb, tb = batches(rand_scan(rng))
        js, jo = jf.filter_step(js, jb, cfg)
        ts, to = tf.filter_step(ts, tb, tcfg)
        _compare_outputs(jo, to)
    _compare_states(js, ts)


def test_wire_forms_match():
    """pack_host_scan_counted is byte-identical; counted_filter_step_wire
    gives the same flat vector (points_xy section to 2 ulp) and
    unpack_output_wire inverts it."""
    cfg = jf.FilterConfig(window=W, beams=B, grid=G, median_backend="inc_xla")
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    js = jf.FilterState.for_config(cfg)
    ts = tf.FilterState.for_config(tcfg, device=CPU)
    rng = np.random.default_rng(9)
    for k in range(W + 2):
        s = rand_scan(rng, n=int(rng.integers(0, 500)))
        jbuf = jf.pack_host_scan_counted(s["angle_q14"], s["dist_q2"], s["quality"], s["flag"], 512)
        tbuf = tf.pack_host_scan_counted(s["angle_q14"], s["dist_q2"], s["quality"], s["flag"], 512)
        assert jbuf.dtype == tbuf.dtype and np.array_equal(jbuf, tbuf)
        js, jw = jf.counted_filter_step_wire(js, jnp.asarray(jbuf), cfg)
        ts, tw = tf.counted_filter_step_wire(ts, torch.from_numpy(tbuf.view(np.int16)), tcfg)
        jw, tw = np.asarray(jw), tw.numpy()
        assert tw.shape == (tf.wire_output_len(tcfg),)
        xy = slice(2 * B, 4 * B)
        np.testing.assert_array_equal(np.delete(jw, np.r_[xy]), np.delete(tw, np.r_[xy]))
        assert ulp_distance(jw[xy], tw[xy]).max() <= 2
        jo, to = jf.unpack_output_wire(jw, cfg), tf.unpack_output_wire(tw, tcfg)
        _compare_outputs(jo, to)
    _compare_states(js, ts)
    with pytest.raises(ValueError):
        tf.unpack_output_wire(tw[:-1], tcfg)
    with pytest.raises(ValueError):
        tf.pack_host_scan_counted(np.zeros(3), np.zeros(3), np.zeros(3), n=2)


def test_unpack_compact_matches():
    rng = np.random.default_rng(10)
    s = rand_scan(rng, n=200, dist_hi=300_000)
    buf = jf.pack_host_scan_counted(s["angle_q14"], s["dist_q2"], s["quality"], s["flag"], 256)
    jb = jf._unpack_compact(jnp.asarray(buf), jnp.asarray(200, jnp.int32))
    tb = tf._unpack_compact(torch.from_numpy(buf.view(np.int16)), torch.tensor(200, dtype=torch.int32))
    for f in ("angle_q14", "dist_q2", "quality", "flag", "valid"):
        np.testing.assert_array_equal(np_(getattr(jb, f)), np_(getattr(tb, f)), err_msg=f)


def test_state_numpy_roundtrip_and_shapes():
    assert tf.FilterState.shapes(W, B, G) == jf.FilterState.shapes(W, B, G)
    cfg = tf.FilterConfig(window=W, beams=B, grid=G, median_backend="inc_xla")
    st = tf.FilterState.for_config(cfg, device=CPU)
    rng = np.random.default_rng(11)
    for _ in range(3):
        _, tb = batches(rand_scan(rng))
        tf.filter_step(st, tb, cfg)
    snap = st.to_numpy()
    assert set(snap) == set(tf.FilterState.shapes(W, B, G))
    assert snap["cursor"].dtype == np.int32 and snap["cursor"].shape == ()
    back = tf.FilterState.from_numpy(snap, device=CPU, with_sorted=True)
    _compare_states(st, back)


def test_config5_geometry_few_revolutions():
    """The main path's geometry (W=64, B=2048, grid 256, capacity 4096,
    3200 points/rev) for a few revolutions through the counted wire step,
    B1 against JAX's temporal_median_pallas (interpret mode on the CPU)."""
    cfg = jf.FilterConfig(window=64, beams=2048, grid=256, cell_m=0.25, median_backend="pallas")
    tcfg = tf.FilterConfig(**dataclasses.asdict(cfg))
    js = jf.FilterState.for_config(cfg)
    ts = tf.FilterState.for_config(tcfg, device=CPU)
    rng = np.random.default_rng(12)
    pts = 3200
    for k in range(3):
        angle = ((np.arange(pts) * 65536) // pts).astype(np.int32)
        dist_m = 2.0 + 0.5 * np.sin(np.arange(pts) * (2 * np.pi / pts) + 0.1 * k)
        dist = (dist_m * 4000.0 + rng.normal(0, 40.0, pts)).astype(np.int32)
        dist[rng.random(pts) < 0.05] = 0
        buf = jf.pack_host_scan_counted(angle, dist, np.full(pts, 190), None, 4096)
        js, jw = jf.counted_filter_step_wire(js, jnp.asarray(buf), cfg)
        ts, tw = tf.counted_filter_step_wire(ts, torch.from_numpy(buf.view(np.int16)), tcfg)
        _compare_outputs(jf.unpack_output_wire(np.asarray(jw), cfg), tf.unpack_output_wire(tw.numpy(), tcfg))
    _compare_states(js, ts)
