"""The PyTorch package's correlative matcher and log-odds update against the
JAX package, bit for bit, on the CPU.

Three oracles: the JAX package's ``xla`` arm, its Pallas kernels in
interpret mode (few and small cases), and the port's own copy of the numpy
reference (``ops/scan_match_ref.py``).  The port is batched over a leading
stream axis; its ``xla`` arm and its kernels' plain versions (what the
``pallas`` arm runs for a CPU tensor) are one code path.  Tolerance is
exact equality everywhere: the datapath is int32 fixed point.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops import pallas_scan_match as jps
from rplidar_ros2_driver_tpu.ops import scan_match as jsm
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.ops import scan_match_ref as ref
from rplidar_ros2_driver_tpu_torch.tools.update_plans import plan_for, stripe_edge_fixture
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SUB, PQ_LIMIT = tsm.SUB, tsm.PQ_LIMIT
BEAMS = 192
# JAX's xla arm compiled whole, as its fused step runs it: one XLA program
# a configuration, not one a primitive and shape (integer arithmetic, so
# the same values as an eager call; each case still holds it to the NumPy
# reference)
jmatch_scan = jax.jit(jsm.match_scan, static_argnums=4)
jupdate_map = jax.jit(jsm.update_map, static_argnums=4)


def _cfg(grid: int = 64, beams: int = BEAMS, clamp_q: int = 8192, **kw) -> tsm.MapConfig:
    kw.setdefault("quant_shift", tsm.min_quant_shift(clamp_q, beams))
    return tsm.MapConfig(grid=grid, cell_m=0.1, beams=beams, clamp_q=clamp_q, **kw)


def _jcfg(cfg: tsm.MapConfig, **over) -> jsm.MapConfig:
    return jsm.MapConfig(**{**dataclasses.asdict(cfg), **over})


def _rand_inputs(rng, cfg, beams):
    """A structured-noise map with saturated blobs, a pose inside the
    translation clamp, and subcell endpoints across the window's edges
    (the JAX suite's fixture)."""
    g = cfg.grid
    lo = rng.integers(-cfg.clamp_q, cfg.clamp_q + 1, (g, g), np.int32)
    lo[rng.integers(0, g, g), rng.integers(0, g, g)] = cfg.clamp_q
    lim = cfg.t_limit_sub
    pose = np.asarray([
        rng.integers(-lim // 2, lim // 2),
        rng.integers(-lim // 2, lim // 2),
        rng.integers(0, cfg.theta_divisions),
    ], np.int32)
    span = min((g // 2) * SUB, PQ_LIMIT)
    pq = rng.integers(-span, span + 1, (beams, 2)).astype(np.int32)
    ok = rng.uniform(size=beams) > 0.15
    return lo, pose, pq, ok


def _t(*arrays):
    """numpy single-stream arrays -> torch tensors with a stream axis of 1."""
    return [torch.from_numpy(np.ascontiguousarray(a))[None] for a in arrays]


def port_match(lo, pose, pq, ok, cfg):
    dp, s, n = tsm.match_scan(*_t(lo, pose, pq, ok), cfg)
    return dp[0].numpy(), int(s[0]), int(n[0])


def port_update(lo, pose, pq, ok, cfg):
    return tsm.update_map(*_t(lo, pose, pq, ok), cfg)[0].numpy()


def assert_match_parity(lo, pose, pq, ok, cfg):
    """Port (both arms) = JAX xla arm = numpy reference."""
    jdp, js, jn = jmatch_scan(lo, pose, pq, ok, _jcfg(cfg))
    ndp, ns, nn = ref.match_scan_np(lo, pose, pq, ok, cfg)
    np.testing.assert_array_equal(np.asarray(jdp), ndp)
    assert int(js) == int(ns) and int(jn) == int(nn)
    for backend in ("xla", "pallas"):
        dp, s, n = port_match(lo, pose, pq, ok, dataclasses.replace(cfg, match_backend=backend))
        np.testing.assert_array_equal(dp, ndp)
        assert (s, n) == (int(ns), int(nn))
    return ndp, int(ns)


def assert_update_parity(lo, pose, pq, ok, cfg):
    want = ref.update_map_np(lo, pose, pq, ok, cfg)
    np.testing.assert_array_equal(np.asarray(jupdate_map(lo, pose, pq, ok, _jcfg(cfg))), want)
    for backend in ("xla", "pallas"):
        got = port_update(lo, pose, pq, ok, dataclasses.replace(cfg, match_backend=backend))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    return want


# ---------------------------------------------------------------------------
# configuration and tables
# ---------------------------------------------------------------------------


def test_constants_and_tables_match_jax():
    for name in ("SUB_BITS", "SUB", "ANG_BITS", "ANG", "LO_SCALE", "W_SCALE", "PQ_LIMIT",
                 "MAP_STATE_VERSION"):
        assert getattr(tsm, name) == getattr(jsm, name), name
    for d in (720, 360, 17):
        np.testing.assert_array_equal(tsm.rotation_table(d), jsm.rotation_table(d))
    cfg = _cfg(theta_window=9)
    np.testing.assert_array_equal(tsm.theta_offsets(cfg), jsm.theta_offsets(_jcfg(cfg)))
    for clamp, beams in ((8192, 2048), (16384, 2048), (8192, 1), (1 << 20, 4096)):
        assert tsm.min_quant_shift(clamp, beams) == jsm.min_quant_shift(clamp, beams)
    assert tsm.MapState.shapes(64) == jsm.MapState.shapes(64)
    cfg = tsm.MapConfig(cell_m=0.07)
    assert cfg.sub_per_m == _jcfg(cfg).sub_per_m and cfg.t_limit_sub == _jcfg(cfg).t_limit_sub


@pytest.mark.parametrize("bad", [
    dict(grid=4), dict(grid=2048), dict(coarse=3), dict(grid=66), dict(cell_m=0.0),
    dict(hit_q=0), dict(miss_q=1), dict(clamp_q=100, hit_q=200), dict(decay_q=-1),
    dict(theta_window=360), dict(match_backend="auto"), dict(quant_shift=0, beams=1 << 20),
])
def test_map_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError) as ours:
        tsm.MapConfig(**bad)
    with pytest.raises(ValueError) as theirs:
        jsm.MapConfig(**bad)
    assert str(ours.value) == str(theirs.value)


def test_pose_to_metric_and_unpack_wire_match_jax():
    cfg = _cfg()
    for pose in ([0, 0, 0], [123, -45, 359], [-2048, 2048, 360], [7, 8, 719]):
        p = np.asarray(pose, np.int32)
        assert tsm.pose_to_metric(p, cfg) == jsm.pose_to_metric(p, _jcfg(cfg))
    wire = np.asarray([1, -2, 3, 4000, 17], np.int32)
    got, want = tsm.unpack_wire(wire), jsm.unpack_wire(wire)
    np.testing.assert_array_equal(got.pop("pose_q"), want.pop("pose_q"))
    assert got == want


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_quantize_points_matches_jax_and_reference():
    cfg = _cfg(grid=256)
    rng = np.random.default_rng(1)
    xy = rng.normal(0.0, 30.0, (4, 512, 2)).astype(np.float32)
    xy[0, :8] = [[np.nan, 0], [0, np.inf], [-np.inf, 1], [102.0, 0], [-102.4, 3],
                 [102.3, 102.3], [0.0015625, -0.0015625], [0.0046875, 0.0078125]]
    xy[1] = np.round(xy[1] * 320) / 320  # exact half-subcell ties
    mask = rng.uniform(size=(4, 512)) > 0.1
    pq, ok = tsm.quantize_points(torch.from_numpy(xy), torch.from_numpy(mask), cfg)
    assert pq.dtype == torch.int32 and ok.dtype == torch.bool
    for s in range(4):
        jpq, jok = jsm.quantize_points(xy[s], mask[s], _jcfg(cfg))
        npq, nok = ref.quantize_points_np(xy[s], mask[s], cfg)
        np.testing.assert_array_equal(pq[s].numpy(), np.asarray(jpq))
        np.testing.assert_array_equal(ok[s].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(pq[s].numpy(), npq)
        np.testing.assert_array_equal(ok[s].numpy(), nok)
    assert not ok[0, :3].any()


def test_rotate_points_matches_jax_at_extremes():
    pq = np.asarray([[PQ_LIMIT, PQ_LIMIT], [-PQ_LIMIT, PQ_LIMIT], [0, -PQ_LIMIT], [5, -7],
                     [-1, -1], [16, 16]], np.int32)
    table = tsm.rotation_table(720)
    for th in (0, 1, 89, 180, 359, 360, 541, 719):
        c, s = table[th]
        got = tsm.rotate_points(torch.from_numpy(pq), int(c), int(s))
        want = jsm.rotate_points(jnp.asarray(pq), jnp.int32(c), jnp.int32(s))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bilinear_gather_matches_jax_with_off_map_corners():
    rng = np.random.default_rng(2)
    g = 16
    mf = rng.integers(0, 600, (3, g * g)).astype(np.int32)
    ix = rng.integers(-3, g + 3, (3, 50, 4, 1)).astype(np.int32)
    iy = rng.integers(-3, g + 3, (3, 50, 1, 4)).astype(np.int32)
    fx = rng.integers(0, SUB, (3, 50, 1, 1)).astype(np.int32)
    fy = rng.integers(0, SUB, (3, 50, 1, 1)).astype(np.int32)
    got = tsm._bilinear_gather(torch.from_numpy(mf), g, *map(torch.from_numpy, (ix, iy, fx, fy)))
    for s in range(3):
        want = jsm._bilinear_gather(jnp.asarray(mf[s]), g, ix[s], iy[s], fx[s], fy[s])
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", [8, 20, 64])
def test_cell_hits_both_arms_match_jax(grid):
    rng = np.random.default_rng(grid)
    cx = rng.integers(-4, grid + 4, (3, 300)).astype(np.int32)
    cy = rng.integers(-4, grid + 4, (3, 300)).astype(np.int32)
    inb = (cx >= 0) & (cx < grid) & (cy >= 0) & (cy < grid) & (rng.uniform(size=(3, 300)) > 0.2)
    args = [torch.from_numpy(a) for a in (cx, cy, inb)]
    scatter = tsm.cell_hits(*args, grid)
    matmul = tsm.cell_hits_matmul(*args, grid)
    assert scatter.dtype == matmul.dtype == torch.int32
    assert torch.equal(scatter, matmul)
    for s in range(3):
        want = jsm.cell_hits(cx[s], cy[s], inb[s], grid)
        np.testing.assert_array_equal(scatter[s].numpy(), np.asarray(want))
        np.testing.assert_array_equal(scatter[s].numpy(), ref.cell_hits_np(cx[s], cy[s], inb[s],
                                                                           grid))
    assert tsm.select_cell_hits("scatter") is tsm.cell_hits
    assert tsm.select_cell_hits("matmul") is tsm.cell_hits_matmul
    with pytest.raises(ValueError, match="voxel_backend"):
        tsm.select_cell_hits("auto")


# ---------------------------------------------------------------------------
# match_scan / update_map across geometries and arms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", [8, 64, 256])
def test_match_scan_bit_exact_across_grids(grid):
    beams = 64 if grid >= 256 else BEAMS
    cfg = _cfg(grid=grid, beams=beams)
    rng = np.random.default_rng(grid)
    for _ in range(3):
        assert_match_parity(*_rand_inputs(rng, cfg, beams), cfg)


@pytest.mark.parametrize("grid", [8, 64, 256])
def test_update_map_bit_exact_across_grids(grid):
    beams = 64 if grid >= 256 else BEAMS
    cfg = _cfg(grid=grid, beams=beams)
    rng = np.random.default_rng(1000 + grid)
    for _ in range(3):
        up = assert_update_parity(*_rand_inputs(rng, cfg, beams), cfg)
        assert np.abs(up).max() <= cfg.clamp_q


@pytest.mark.parametrize("voxel", ["scatter", "matmul"])
@pytest.mark.parametrize("decay_q", [0, 300])
def test_update_map_voxel_arms_and_decay(voxel, decay_q):
    cfg = _cfg(voxel_backend=voxel, decay_q=decay_q)
    rng = np.random.default_rng(7)
    lo, pose, pq, ok = _rand_inputs(rng, cfg, BEAMS)
    assert_update_parity(lo, pose, pq, ok, cfg)


def test_free_samples_zero_skips_the_miss_pass():
    cfg = _cfg(free_samples=0)
    lo, pose, pq, ok = _rand_inputs(np.random.default_rng(8), cfg, BEAMS)
    up = assert_update_parity(lo, pose, pq, ok, cfg)
    assert (up >= np.clip(lo, -cfg.clamp_q, cfg.clamp_q)).all()


@pytest.mark.parametrize("grid", [44, 92])  # G/4 = 11 and 23: odd, prime
def test_odd_and_prime_coarse_grids(grid):
    cfg = _cfg(grid=grid)
    rng = np.random.default_rng(grid)
    for _ in range(2):
        inputs = _rand_inputs(rng, cfg, BEAMS)
        assert_match_parity(*inputs, cfg)
        assert_update_parity(*inputs, cfg)


# ---------------------------------------------------------------------------
# edge fixtures (the JAX suite's)
# ---------------------------------------------------------------------------


def test_all_invalid_scan():
    cfg = _cfg()
    lo, pose, pq, _ = _rand_inputs(np.random.default_rng(11), cfg, BEAMS)
    ok = np.zeros(BEAMS, bool)
    dp, score = assert_match_parity(lo, pose, pq, ok, cfg)
    assert score == 0 and tuple(dp) == (0, 0, 0)
    up = assert_update_parity(lo, pose, pq, ok, cfg)
    np.testing.assert_array_equal(up, np.clip(lo, -cfg.clamp_q, cfg.clamp_q))


def test_single_valid_beam_and_one_beam_config():
    cfg = _cfg()
    lo, pose, pq, _ = _rand_inputs(np.random.default_rng(12), cfg, BEAMS)
    ok = np.zeros(BEAMS, bool)
    ok[0] = True
    assert_match_parity(lo, pose, pq, ok, cfg)
    assert_update_parity(lo, pose, pq, ok, cfg)
    one = _cfg(beams=1)
    lo, pose, pq, ok = _rand_inputs(np.random.default_rng(13), one, 1)
    ok[:] = True
    assert_match_parity(lo, pose, pq, ok, one)
    assert_update_parity(lo, pose, pq, ok, one)


def test_far_points_at_the_int32_wrap_guard():
    cfg = _cfg()
    pq = np.asarray(
        [[PQ_LIMIT, PQ_LIMIT], [-PQ_LIMIT, PQ_LIMIT], [PQ_LIMIT, -PQ_LIMIT],
         [-PQ_LIMIT, -PQ_LIMIT], [PQ_LIMIT, 0], [0, -PQ_LIMIT]] + [[0, 0]] * (BEAMS - 6),
        np.int32,
    )
    ok = np.ones(BEAMS, bool)
    lo = np.random.default_rng(13).integers(0, cfg.clamp_q + 1, (64, 64), np.int32)
    for th in (0, 137, 359):
        pose = np.asarray([0, 0, th], np.int32)
        assert_match_parity(lo, pose, pq, ok, cfg)
        assert_update_parity(lo, pose, pq, ok, cfg)


def test_uniform_map_tie_picks_the_first_candidate_in_c_order():
    cfg = _cfg()
    lo = np.full((64, 64), 4096, np.int32)
    pq = np.zeros((BEAMS, 2), np.int32)
    ok = np.zeros(BEAMS, bool)
    ok[0] = True
    dp, score = assert_match_parity(lo, np.zeros(3, np.int32), pq, ok, cfg)
    assert score > 0
    w, r, c = cfg.window_cells, cfg.fine_radius, cfg.coarse
    np.testing.assert_array_equal(
        dp, [(-w * c - r) * SUB, (-w * c - r) * SUB, tsm.theta_offsets(cfg)[0]]
    )


def test_two_way_tie_earlier_flat_index_wins():
    cfg = _cfg()
    g = cfg.grid
    lo = np.zeros((g, g), np.int32)
    for d in (2, 6):
        lo[g // 2 - d, g // 2] = 4096
        lo[g // 2 + d, g // 2] = 4096
    pq = np.zeros((BEAMS, 2), np.int32)
    ok = np.zeros(BEAMS, bool)
    ok[0] = True
    _dp, score = assert_match_parity(lo, np.zeros(3, np.int32), pq, ok, cfg)
    assert score > 0


def test_saturated_map_at_min_quant_shift():
    beams, clamp_q = 2048, 16384
    shift = tsm.min_quant_shift(clamp_q, beams)
    assert shift > 0 and (clamp_q >> (shift - 1)) * SUB * SUB * beams >= 2**31
    cfg = tsm.MapConfig(grid=64, cell_m=0.1, beams=beams, clamp_q=clamp_q, quant_shift=shift)
    lo = np.full((64, 64), clamp_q, np.int32)
    pq = np.zeros((beams, 2), np.int32)
    ok = np.ones(beams, bool)
    _dp, score = assert_match_parity(lo, np.zeros(3, np.int32), pq, ok, cfg)
    assert score == (clamp_q >> shift) * SUB * SUB * beams
    assert_update_parity(lo, np.zeros(3, np.int32), pq, ok, cfg)


def test_nonfinite_points_through_the_step():
    cfg = _cfg()
    pts = np.full((BEAMS, 2), np.inf, np.float32)
    pts[: BEAMS // 2] = np.nan
    mask = np.ones(BEAMS, bool)
    state = tsm.MapState.create(cfg, 1)
    state, wire = tsm.map_match_step(state, torch.from_numpy(pts), torch.from_numpy(mask), 1, cfg)
    jstate, jwire = jsm.map_match_step(jsm.MapState.create(_jcfg(cfg)), pts, mask, np.int32(1),
                                       cfg=_jcfg(cfg))
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jwire))
    assert int(state.log_odds.count_nonzero()) == 0 and int(state.revision[0]) == 1


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX package's Pallas kernels
# (interpret mode) — B6, B7, B8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,beams", [(8, 32), (64, 192)])
def test_plain_kernels_match_pallas_interpret(grid, beams):
    cfg = _cfg(grid=grid, beams=beams)
    jcfg = _jcfg(cfg, match_backend="pallas")
    rng = np.random.default_rng(grid + beams)
    center = (grid // 2) * SUB
    table = tsm.rotation_table(cfg.theta_divisions)
    streams = [_rand_inputs(rng, cfg, beams) for _ in range(2)]
    lo, pose, pq, ok = (np.stack(x) for x in zip(*streams))
    posec = (pose[:, :2] + center).astype(np.int32)
    trig = table[pose[:, 2]]
    mq, score_c = smk.coarse_scores_plain(*map(torch.from_numpy, (lo, pq, ok, posec, trig)), cfg)
    cos_q, sin_q = tsm._theta_trig(torch.from_numpy(pose), cfg)
    uv = rng.integers(-cfg.window_cells, cfg.window_cells + 1, (2, 2)).astype(np.int32)
    score_f = smk.fine_scores_plain(mq, *map(torch.from_numpy, (pq, ok, posec)), cos_q, sin_q,
                                    torch.from_numpy(uv), cfg)
    updated = smk.log_odds_update_plain(*map(torch.from_numpy, (lo, pq, ok, posec, trig)), cfg)
    for s in range(2):
        jmq, jsc = jps.coarse_scores_pallas(
            jnp.asarray(lo[s]), jnp.asarray(pq[s]), jnp.asarray(ok[s]), jnp.asarray(posec[s]),
            jnp.int32(trig[s, 0]), jnp.int32(trig[s, 1]), jcfg, interpret=True,
        )
        np.testing.assert_array_equal(mq[s].numpy(), np.asarray(jmq))
        np.testing.assert_array_equal(score_c[s].numpy(), np.asarray(jsc))
        jsf = jps.fine_scores_pallas(
            jmq, jnp.asarray(pq[s]), jnp.asarray(ok[s]), jnp.asarray(posec[s]),
            jnp.asarray(cos_q[s].numpy()), jnp.asarray(sin_q[s].numpy()),
            jnp.int32(uv[s, 0]), jnp.int32(uv[s, 1]), jcfg, interpret=True,
        )
        np.testing.assert_array_equal(score_f[s].numpy(), np.asarray(jsf))
        jup = jps.log_odds_update_pallas(
            jnp.asarray(lo[s]), jnp.asarray(pq[s]), jnp.asarray(ok[s]), jnp.asarray(posec[s]),
            jnp.int32(trig[s, 0]), jnp.int32(trig[s, 1]), jcfg, interpret=True,
        )
        np.testing.assert_array_equal(updated[s].numpy(), np.asarray(jup))


@pytest.mark.parametrize("samples", [0, 1, 3, 4])
@pytest.mark.parametrize("grid,streams,rows", [(24, 3, 2), (64, 1, 4), (64, 4, 8), (18, 2, 3),
                                                (9, 1, 2)])
def test_b8_plain_matches_pallas_interpret_on_stripe_edges(grid, streams, rows, samples):
    """The log-odds update's plain version against log_odds_update_pallas
    in interpret mode on the CUDA kernel's stripe edges: hits and samples
    on the first and last row of each block's stripe, off the map on each
    side, hit and free in one cell, free_samples 0, 1, 3, 4, a saturated
    map at free_samples 4."""
    coarse = 4 if grid % 4 == 0 else (2 if grid % 2 == 0 else 1)  # the grid must divide by it
    _name, cfg, lo, pose, pq, ok = stripe_edge_fixture(
        np.random.default_rng(grid + streams + samples), grid, streams, rows, samples,
        samples == 4, coarse)
    jcfg = _jcfg(cfg, match_backend="pallas")
    posec = (pose[:, :2] + (grid // 2) * SUB).astype(np.int32)
    trig = tsm.rotation_table(cfg.theta_divisions)[pose[:, 2]]
    got = smk.log_odds_update_kernel(*map(torch.from_numpy, (lo, pq, ok, posec, trig)), cfg)
    touched = np.zeros(grid, bool)
    for st in range(streams):
        jup = jps.log_odds_update_pallas(
            jnp.asarray(lo[st]), jnp.asarray(pq[st]), jnp.asarray(ok[st]), jnp.asarray(posec[st]),
            jnp.int32(trig[st, 0]), jnp.int32(trig[st, 1]), jcfg, interpret=True,
        )
        np.testing.assert_array_equal(got[st].numpy(), np.asarray(jup))
        touched |= (got[st].numpy() != np.clip(lo[st], -cfg.clamp_q, cfg.clamp_q)).any(axis=1)
    # marks landed on both edge rows of the stripes
    r = np.flatnonzero(touched)
    assert (r % rows == 0).any() and (r % rows == rows - 1).any()


def test_wrappers_take_the_plain_version_only_on_the_cpu(monkeypatch):
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on another device never reaches the plain version — it launches the
    kernel (CUDA) or raises."""
    cfg = _cfg()
    lo, pose, pq, ok = _rand_inputs(np.random.default_rng(3), cfg, BEAMS)
    center = (cfg.grid // 2) * SUB
    posec = (pose[None, :2] + center).astype(np.int32)
    trig = tsm.rotation_table(720)[pose[None, 2]]
    args = _t(lo, pq, ok) + [torch.from_numpy(posec), torch.from_numpy(trig)]
    smk.reset_launch_counts()
    mq, sc = smk.coarse_scores_kernel(*args, cfg)
    pmq, psc = smk.coarse_scores_plain(*args, cfg)
    assert torch.equal(mq, pmq) and torch.equal(sc, psc)
    assert torch.equal(smk.log_odds_update_kernel(*args, cfg),
                       smk.log_odds_update_plain(*args, cfg))
    assert smk.launch_counts == {"coarse_scores": 0, "fine_scores": 0, "log_odds_update": 0}

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    for name in ("coarse_scores_plain", "fine_scores_plain", "log_odds_update_plain"):
        monkeypatch.setattr(smk, name, boom)
    meta = [a.to("meta") for a in args]
    with pytest.raises(RuntimeError, match="no coarse-scores kernel for device meta"):
        smk.coarse_scores_kernel(*meta, cfg)
    with pytest.raises(RuntimeError, match="no log-odds-update kernel"):
        smk.log_odds_update_kernel(*meta, cfg)
    t = 2 * cfg.theta_window + 1
    trig_t = torch.zeros((1, t), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no fine-scores kernel"):
        smk.fine_scores_kernel(meta[0], meta[1], meta[2], meta[3], trig_t, trig_t,
                               torch.zeros((1, 2), dtype=torch.int32, device="meta"), cfg)
    assert smk.launch_counts == {"coarse_scores": 0, "fine_scores": 0, "log_odds_update": 0}


def test_wrappers_check_their_arguments():
    cfg = _cfg()
    lo, pose, pq, ok = _rand_inputs(np.random.default_rng(4), cfg, BEAMS)
    lo_t, pq_t, ok_t = _t(lo, pq, ok)
    posec = torch.zeros((1, 2), dtype=torch.int32)
    trig = torch.tensor([[1 << 14, 0]], dtype=torch.int32)
    with pytest.raises(TypeError, match="log_odds must be torch.int32"):
        smk.coarse_scores_kernel(lo_t.to(torch.int64), pq_t, ok_t, posec, trig, cfg)
    with pytest.raises(TypeError, match="ok must be torch.bool"):
        smk.log_odds_update_kernel(lo_t, pq_t, ok_t.to(torch.int32), posec, trig, cfg)
    with pytest.raises(ValueError, match="log_odds must have shape"):
        smk.coarse_scores_kernel(lo_t[:, :32, :32].contiguous(), pq_t, ok_t, posec, trig, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        smk.log_odds_update_kernel(lo_t.transpose(1, 2), pq_t, ok_t, posec, trig, cfg)
    with pytest.raises(ValueError, match="trig must have shape"):
        smk.coarse_scores_kernel(lo_t, pq_t, ok_t, posec, trig[:, :1].contiguous(), cfg)


# ---------------------------------------------------------------------------
# the batched fleet step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batched_step_equals_single_stream_steps(backend):
    """One fleet call of N=4 streams (one idle) equals four single-stream
    steps, and the JAX package's vmapped fleet step."""
    cfg = _cfg(match_backend=backend)
    rng = np.random.default_rng(21)
    n, b = 4, BEAMS
    lo0 = np.stack([_rand_inputs(rng, cfg, b)[0] for _ in range(n)])
    pose0 = np.asarray([[32, -64, 700], [0, 0, 0], [-500, 300, 10], [64, 64, 359]], np.int32)
    pts = rng.normal(0.0, 1.5, (n, b, 2)).astype(np.float32)
    masks = rng.uniform(size=(n, b)) > 0.1
    live = np.asarray([1, 1, 0, 1], np.int32)

    state = tsm.MapState.from_numpy({"log_odds": lo0, "pose": pose0,
                                     "origin_xy": np.zeros((n, 2), np.float32),
                                     "revision": np.arange(n, dtype=np.int32)}, "cpu")
    held = state.log_odds
    state, wire = tsm.fleet_map_match_step(state, *map(torch.from_numpy, (pts, masks, live)), cfg)
    assert state.log_odds is held  # in place
    for i in range(n):
        one = tsm.MapState.from_numpy({"log_odds": lo0[i:i + 1], "pose": pose0[i:i + 1],
                                       "origin_xy": np.zeros((1, 2), np.float32),
                                       "revision": np.asarray([i], np.int32)}, "cpu")
        one, w1 = tsm.map_match_step(one, torch.from_numpy(pts[i]), torch.from_numpy(masks[i]),
                                     int(live[i]), cfg)
        np.testing.assert_array_equal(wire[i].numpy(), w1.numpy())
        np.testing.assert_array_equal(state.log_odds[i].numpy(), one.log_odds[0].numpy())
        np.testing.assert_array_equal(state.pose[i].numpy(), one.pose[0].numpy())
    # the idle stream passes through untouched and reports no match
    np.testing.assert_array_equal(state.log_odds[2].numpy(), lo0[2])
    np.testing.assert_array_equal(wire[2].numpy(), [*pose0[2], 0, 0])
    np.testing.assert_array_equal(state.revision.numpy(), [1, 2, 2, 4])

    jstates = jsm.MapState(log_odds=jnp.asarray(lo0), pose=jnp.asarray(pose0),
                           origin_xy=jnp.zeros((n, 2), jnp.float32),
                           revision=jnp.arange(n, dtype=jnp.int32))
    jstates, jwire = jsm.fleet_map_match_step(jstates, pts, masks, live, cfg=_jcfg(cfg))
    np.testing.assert_array_equal(wire.numpy(), np.asarray(jwire))
    np.testing.assert_array_equal(state.log_odds.numpy(), np.asarray(jstates.log_odds))
    np.testing.assert_array_equal(state.revision.numpy(), np.asarray(jstates.revision))


# ---------------------------------------------------------------------------
# B6/B7's shapes off the register path, and their launch plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window,radius", [(1, 1), (5, 3), (0, 0), (3, 2)])
def test_match_scan_bit_exact_off_the_register_windows(window, radius):
    """Windows and radii the kernels serve from shared-memory accumulators
    (not instantiated with register-held sums): the plain versions, which
    the card holds the kernels to, against the JAX package."""
    assert window not in smk.COARSE_WINDOWS and radius not in smk.FINE_RADII
    cfg = _cfg(window_cells=window, fine_radius=radius)
    rng = np.random.default_rng(31 + window)
    for _ in range(2):
        assert_match_parity(*_rand_inputs(rng, cfg, BEAMS), cfg)


@pytest.mark.parametrize("clamp_q", [32767, 32768])
def test_pooled_map_int16_edge_matches_jax(clamp_q):
    """mq up to clamp_q >> quant_shift: 32767 takes B6's int16 pooled map,
    32768 the direct route; a saturated half reaches the edge."""
    cfg = _cfg(beams=63, clamp_q=clamp_q)
    assert cfg.quant_shift == 0
    lo, pose, pq, ok = _rand_inputs(np.random.default_rng(clamp_q), cfg, 63)
    lo[: cfg.grid // 2] = clamp_q
    assert_match_parity(lo, pose, pq, ok, cfg)
    elem = smk.coarse_plan(1, cfg.grid, cfg.coarse, cfg.window_cells, clamp_q, 0, 132)[0]
    assert elem == (2 if clamp_q <= smk.INT16_MAX else 0)


def _layout_bytes(pooled: int, f: int, rows: int, threads: int, registers: bool) -> int:
    """csrc/scan_match.cu's block layout: [pooled][part F²][red threads·slot]
    [hrow F·threads on the shared-memory path], slot = rows·F made odd."""
    slot = (rows * f) | 1
    return pooled + 4 * (f * f + threads * slot + (0 if registers else f * threads))


@pytest.mark.parametrize("beams", [1, 192, 2048])
@pytest.mark.parametrize("streams", [1, 3, 4])
@pytest.mark.parametrize("grid", [8, 44, 64, 92, 256, 1024])
def test_launch_plans_over_the_fixture_shapes(grid, streams, beams):
    """The plans are pure, fill the card with clusters of at most 8 blocks
    in one wave and give each block the shared memory its layout takes,
    within the card's limit; the cluster does not depend on B (a block may
    get no beams)."""
    cfg = _cfg(grid=grid, beams=beams)
    t, f, u = 2 * cfg.theta_window + 1, 2 * cfg.fine_radius + 1, 2 * cfg.window_cells + 1
    for sms in (132, 114):
        fine = smk.fine_plan(streams, t, cfg.fine_radius, sms)
        coarse = smk.coarse_plan(streams, grid, cfg.coarse, cfg.window_cells, cfg.clamp_q,
                                 cfg.quant_shift, sms)
        smk.fine_plan.cache_clear()
        smk.coarse_plan.cache_clear()
        assert fine == smk.fine_plan(streams, t, cfg.fine_radius, sms)
        assert coarse == smk.coarse_plan(streams, grid, cfg.coarse, cfg.window_cells,
                                         cfg.clamp_q, cfg.quant_shift, sms)
        cluster, threads, rows, smem = fine
        resident = 0.8 * sms * smk.FINE_THREADS_PER_SM
        assert cluster in (1, 2, 4, 8) and threads == smk.MAX_THREADS == 256
        assert streams * t * cluster * threads <= resident or cluster == 1
        assert cluster == smk.MAX_CLUSTER or streams * t * 2 * cluster * threads > resident
        assert rows == f and smem == _layout_bytes(0, f, rows, threads, True) <= smk.SMEM_LIMIT
        elem, cluster, threads, rows, smem = coarse
        gc = grid // cfg.coarse
        assert elem == 2 and cluster == min(smk.MAX_CLUSTER, 2 * sms // streams)
        pooled = -(-gc * gc * elem // 16) * 16
        assert rows == u and smem == _layout_bytes(pooled, u, rows, threads, True)
        assert smem <= smk.SMEM_LIMIT


def test_launch_plan_routes():
    # the pooled map: int16, or the direct route when mq does not fit int16
    # or the map does not fit in shared memory
    assert smk.coarse_plan(1, 256, 4, 2, 8192, 0, 132)[0] == 2
    assert smk.coarse_plan(1, 256, 4, 2, 1 << 16, 0, 132)[0] == 0
    assert smk.coarse_plan(1, 1024, 4, 2, 8192, 0, 132)[0] == 2      # 128 KiB of int16
    assert smk.coarse_plan(1, 1024, 4, 2, 1 << 16, 0, 132)[0] == 0
    assert smk.coarse_plan(1, 1024, 2, 2, 8192, 0, 132)[0] == 0      # 512 KiB of int16
    assert smk.coarse_plan(1, 1024, 4, 2, 65535, 1, 132)[0] == 2     # mq <= 65535 >> 1 = 32767
    # the two path shapes: config 12's tick and the map replay's
    assert smk.fine_plan(4, 13, 4, 132)[:2] == (4, 256)
    assert smk.fine_plan(1, 13, 4, 132)[:2] == (8, 256)
    assert smk.coarse_plan(4, 256, 4, 2, 8192, 0, 132)[1:3] == (8, 128)
    # off the register path: the candidate rows in chunks that fit
    for r in (1, 3, 7, 20):
        cluster, threads, rows, smem = smk.fine_plan(1, 13, r, 132)
        f = 2 * r + 1
        assert 1 <= rows <= f
        assert smem == _layout_bytes(0, f, rows, threads, False) <= smk.SMEM_LIMIT
    assert smk.fine_plan(1, 13, 20, 132)[2] < 41
    elem, _c, threads, rows, smem = smk.coarse_plan(3, 64, 4, 12, 8192, 0, 132)
    assert rows < 25 and smem == _layout_bytes(16 * 16 * 2, 25, rows, threads, False)
    with pytest.raises(ValueError, match="fine_radius 200"):
        smk.fine_plan(1, 13, 200, 132)
    with pytest.raises(ValueError, match="window_cells 200"):
        smk.coarse_plan(1, 64, 4, 200, 8192, 0, 132)


def test_register_instantiations_match_the_source():
    """The r and w values the wrappers plan on the register path are the
    ones csrc/scan_match.cu instantiates."""
    import re

    from rplidar_ros2_driver_tpu_torch.utils.cuda_build import CSRC_DIR

    text = (CSRC_DIR / "scan_match.cu").read_text()
    fine = {int(r) for r in re.findall(r"launch_fine<(\d+)>\(", text)}
    coarse = {int(w) for w in re.findall(r"launch_coarse<(\d+), STAGED>\(", text)}
    assert tuple(sorted(fine - {0})) == smk.FINE_RADII and 0 in fine
    assert tuple(sorted(coarse - {0})) == smk.COARSE_WINDOWS and 0 in coarse


def _update_layout_bytes(local: bool, rows: int, g: int) -> int:
    """csrc/scan_match.cu's B8 block layout, two bits a cell in 32-bit
    words: [the map's bitmap, padded to 16 bytes][the stripe's words and
    one more] (local) or [the stripe's words] (remote), in 16-byte units."""
    words = ((((g * g + 15) // 16 + 3) // 4) * 4 if local else 0) \
        + (rows * g + 15) // 16 + (1 if local else 0)
    return (words + 3) // 4 * 16


@pytest.mark.parametrize("streams", [1, 3, 4])
@pytest.mark.parametrize("grid", [8, 9, 18, 24, 44, 64, 92, 256, 935, 936, 1000, 1024])
def test_update_plan_over_the_grid_range(grid, streams):
    """B8's plan is pure, its stripes cover every row once, its layout fits
    a block's shared memory (the local route wherever the map's bitmap
    does), and its cluster is a power of two the kernel is prepared for,
    filling at most one block a SM."""
    for sms in (132, 114):
        plan = smk.update_plan(streams, grid, sms)
        smk.update_plan.cache_clear()
        assert plan == smk.update_plan(streams, grid, sms)
        local, cluster, threads, rows, smem = plan
        assert cluster & (cluster - 1) == 0 and 1 <= cluster <= smk.UPDATE_MAX_CLUSTER
        assert cluster <= grid and streams * cluster <= sms
        assert cluster == smk.UPDATE_MAX_CLUSTER or 2 * cluster > grid or \
            streams * 2 * cluster > sms
        assert threads == smk.UPDATE_THREADS
        owner = np.concatenate([np.full(max(0, min(grid, (k + 1) * rows) - min(grid, k * rows)), k)
                                for k in range(cluster)])
        assert owner.shape == (grid,)                     # every row once, in order
        np.testing.assert_array_equal(owner, np.arange(grid) // rows)
        assert smem == smk.update_bytes(local, rows, grid)
        assert smem == _update_layout_bytes(local, rows, grid)
        assert smem <= smk.SMEM_LIMIT
        assert local == (_update_layout_bytes(True, rows, grid) <= smk.SMEM_LIMIT)
    # half the cluster, as tools/update_plans.py times it beside the plan
    assert plan_for(1, 8, 256) == (1, 8, smk.UPDATE_THREADS, 32, 18448)


def test_update_plan_routes():
    assert smk.update_plan(4, 256, 132) == (1, 16, 512, 16, 17424)  # config 12's tick
    assert smk.update_plan(1, 256, 132) == (1, 16, 512, 16, 17424)  # the map replay's
    assert smk.update_plan(9, 256, 132)[:2] == (1, 8)               # 9 x 16 blocks > 132 SMs
    assert smk.update_plan(3, 8, 132)[:4] == (1, 8, 512, 1)         # no wider than G
    # the map's bitmap fits a block up to G = 935: past it, the remote route
    assert smk.update_plan(1, 935, 132)[0] == 1
    assert smk.update_plan(1, 936, 132)[0] == 0
    assert smk.update_plan(1, 1024, 132) == (0, 16, 512, 64, 16384)
    # many streams: one block a stream, until a stripe of the whole map
    # does not fit a block (G=1024: 256 KiB of flags), then two
    assert smk.update_plan(200, 256, 132) == (1, 1, 512, 256, 32784)
    assert smk.update_plan(200, 1024, 132) == (0, 2, 512, 512, 131072)


def test_update_instantiations_match_the_source():
    """The wrapper's constants are csrc/scan_match.cu's (the launch bound,
    the largest cluster the entry accepts), and B8 is instantiated, on both
    routes, for the repo's free_samples and the runtime path (0)."""
    import re

    from rplidar_ros2_driver_tpu_torch.utils.cuda_build import CSRC_DIR

    text = (CSRC_DIR / "scan_match.cu").read_text()
    assert int(re.search(r"kUpdateThreads = (\d+);", text)[1]) == smk.UPDATE_THREADS
    assert int(re.search(r"kUpdateMaxCluster = (\d+);", text)[1]) == smk.UPDATE_MAX_CLUSTER
    samples = {int(v) for v in re.findall(r"launch_update<(\d+), kLocal>\(", text)}
    assert samples == {0, tsm.MapConfig().free_samples}
    assert "update_by_samples<true>(" in text and "update_by_samples<false>(" in text
    assert "__launch_bounds__(kUpdateThreads)" in text
