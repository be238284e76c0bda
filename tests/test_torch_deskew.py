"""The PyTorch package's de-skew + sweep reconstruction against the JAX
package, bit for bit, on the CPU.

Oracles: the JAX package's ``xla`` arm, its Pallas kernels B4/B5 in
interpret mode (few, small cases) and its numpy twin (``ops/deskew_ref.py``).
The port's ``xla`` arm and its kernels' plain versions — what the
``pallas`` arm runs for a CPU tensor — are one code path.  Tolerance is
exact equality on every int32 plane; ``recon_points`` xy within 2 ulp (the
port's host-built trig table, ROADMAP C.1).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops import deskew as jd
from rplidar_ros2_driver_tpu.ops import deskew_ref as jref
from rplidar_ros2_driver_tpu.ops import pallas_deskew as jpd
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.ops import deskew as td
from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops import deskew_ref as tref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
EMPTY = td.RECON_EMPTY
# JAX's integer blocks compiled whole, as its fused ingest runs them: one
# XLA program a configuration and shape, not one a primitive and shape
# (integer arithmetic: the same values as an eager call)
jbeam_of = jax.jit(jd.beam_of, static_argnames=("beams",))
jprofile_from_nodes = jax.jit(jd.profile_from_nodes, static_argnames=("cfg", "block"))
jrasterize_subsweep = jax.jit(jd.rasterize_subsweep, static_argnames=("cfg", "block"))
jestimate_motion = jax.jit(jd.estimate_motion, static_argnames=("cfg",))
japply_deskew = jax.jit(jd.apply_deskew, static_argnames=("cfg",))
# the four (recon_beams, profile_beams) geometries of the JAX kernel suite
GEOMETRIES = [(256, 64), (2048, 256), (100, 128), (8, 1024)]


def _cfgs(beams=BEAMS, prof=64, backend="xla", **over):
    kw = dict(recon_beams=beams, profile_beams=prof, shift_window=min(8, prof // 8),
              recon_window=3, **over)
    return td.DeskewConfig(backend=backend, **kw), jd.DeskewConfig(backend=backend, **kw)


def _rand_nodes(rng, n=600):
    angle = rng.integers(0, 65536, n).astype(np.int32)
    dist = rng.integers(0, 0x3FFFF, n).astype(np.int32)
    dist[rng.random(n) < 0.1] = 0
    quality = rng.integers(0, 256, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    return angle, dist, quality, valid


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _room_profile(d):
    return (4000 + 1500 * np.sin(2 * np.pi * np.arange(d) / d * 3.0)).astype(np.int32)


def _ulp_close(got, want, ulps=2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    spacing = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return bool(np.all(np.abs(got - want) <= ulps * spacing))


# ---------------------------------------------------------------------------
# building blocks against the JAX xla arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beams,prof,clip", [g + (i % 2 == 0,) for i, g in enumerate(GEOMETRIES)])
def test_blocks_match_jax(beams, prof, clip):
    tc, jc = _cfgs(beams, prof, enable_clip=clip, range_min_m=2.0, range_max_m=30.0,
                   intensity_min=20.0)
    rng = np.random.default_rng(beams + prof + clip)
    for _ in range(2):
        angle, dist, quality, valid = _rand_nodes(rng)
        ta, tdist, tq, tv = _t(angle, dist, quality, valid)
        np.testing.assert_array_equal(td.beam_of(ta, beams).numpy(),
                                      np.asarray(jbeam_of(jnp.asarray(angle), beams)))
        np.testing.assert_array_equal(
            td.profile_from_nodes(ta, tdist, tv, tc).numpy(),
            np.asarray(jprofile_from_nodes(angle, dist, valid, jc)))
        np.testing.assert_array_equal(
            td.rasterize_subsweep(ta, tdist, tq, tv, tc).numpy(),
            np.asarray(jrasterize_subsweep(angle, dist, quality, valid, jc)))
        a2, d2, _q, v2 = _rand_nodes(rng)
        p1 = jref.profile_from_nodes_np(angle, dist, valid, jc)
        p2 = jref.profile_from_nodes_np(a2, d2, v2, jc)
        mj = np.asarray(jestimate_motion(p1, p2, jc))
        np.testing.assert_array_equal(td.estimate_motion(*_t(p1, p2), tc).numpy(), mj)
        motion = np.asarray([rng.integers(-2048, 2049), rng.integers(-2048, 2049),
                             rng.integers(-(1 << 13), (1 << 13) + 1)], np.int32)
        aj, dj = japply_deskew(angle, dist, valid, motion, jc)
        at, dt = td.apply_deskew(ta, tdist, tv, torch.from_numpy(motion), tc)
        np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_batched_rows_equal_per_row_calls():
    """The port runs every block over leading axes (streams x slots): one
    batched call equals the per-row JAX calls row for row."""
    tc, jc = _cfgs()
    rng = np.random.default_rng(7)
    rows = [_rand_nodes(rng, 300) for _ in range(6)]
    a, d, q, v = (np.stack(c).reshape(2, 3, 300) for c in zip(*rows))
    ta, tdist, tq, tv = _t(a, d, q, v)
    profs = td.profile_from_nodes(ta, tdist, tv, tc)
    segs = td.rasterize_subsweep(ta, tdist, tq, tv, tc)
    prev = torch.roll(profs, 1, dims=1)
    motion = td.estimate_motion(prev, profs, tc)
    a2, d2 = td.apply_deskew(ta, tdist, tv, motion, tc)
    for i in range(2):
        for j in range(3):
            pj = np.asarray(jprofile_from_nodes(a[i, j], d[i, j], v[i, j], jc))
            np.testing.assert_array_equal(profs[i, j].numpy(), pj)
            np.testing.assert_array_equal(
                segs[i, j].numpy(),
                np.asarray(jrasterize_subsweep(a[i, j], d[i, j], q[i, j], v[i, j], jc)))
            mj = np.asarray(jestimate_motion(prev[i, j].numpy(), pj, jc))
            np.testing.assert_array_equal(motion[i, j].numpy(), mj)
            aj, dj = japply_deskew(a[i, j], d[i, j], v[i, j], mj, jc)
            np.testing.assert_array_equal(a2[i, j].numpy(), np.asarray(aj))
            np.testing.assert_array_equal(d2[i, j].numpy(), np.asarray(dj))


@pytest.mark.parametrize("s0", [-3, -1, 1, 3])
def test_estimator_rotation_matches_jax(s0):
    tc, jc = _cfgs()
    prof = _room_profile(64)
    cur = np.roll(prof, -s0)
    m = td.estimate_motion(*_t(prof, cur), tc).numpy()
    np.testing.assert_array_equal(m, np.asarray(jestimate_motion(prof, cur, jc)))
    assert m[2] == s0 * (65536 // 64)


@pytest.mark.parametrize("dx,dy", [(300, 0), (0, -250), (200, 150)])
def test_estimator_translation_matches_jax(dx, dy):
    tc, jc = _cfgs()
    prof = _room_profile(64)
    trig = td.profile_trig(tc)
    np.testing.assert_array_equal(trig, jd.profile_trig(jc))
    radial = (dx * trig[:, 0] + dy * trig[:, 1] + (1 << 13)) >> 14
    cur = (prof - radial).astype(np.int32)
    m = td.estimate_motion(*_t(prof, cur), tc).numpy()
    np.testing.assert_array_equal(m, np.asarray(jestimate_motion(prof, cur, jc)))
    assert m[2] == 0 and (dx == 0 or np.sign(m[0]) == np.sign(dx))


def test_featureless_tie_and_empty_estimate_identity():
    for backend in ("xla", "pallas"):
        tc, _ = _cfgs(backend=backend)
        flat = np.full(64, 5000, np.int32)
        empty = np.full(64, EMPTY, np.int32)
        for a, b in ((flat, flat), (empty, empty), (flat, empty)):
            np.testing.assert_array_equal(td.estimate_motion(*_t(a, b), tc).numpy(),
                                          np.zeros(3, np.int32))


def test_ring_push_combine_and_recon_points_match_jax():
    tc, jc = _cfgs()
    rng = np.random.default_rng(5)
    k = tc.recon_window
    jring = jnp.full((k, BEAMS), EMPTY, jnp.int32)
    jpos = jnp.asarray(0, jnp.int32)
    tring = torch.full((k, BEAMS), EMPTY, dtype=torch.int32)
    tpos = torch.zeros((), dtype=torch.int32)
    for step in range(8):
        angle, dist, quality, valid = _rand_nodes(rng, 200)
        seg = jref.rasterize_subsweep_np(angle, dist, quality, valid, jc)
        pushed = step != 4  # an idle tick leaves the ring untouched
        jring, jpos = jd.push_ring(jring, jpos, jnp.asarray(seg), jnp.asarray(pushed))
        tring, tpos = td.push_ring(tring, tpos, torch.from_numpy(seg), torch.tensor(pushed))
        np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
        assert int(tpos) == int(jpos)
        jc_plane = np.asarray(jd.combine_ring(jring, jpos))
        tc_plane = td.combine_ring(tring, tpos)
        np.testing.assert_array_equal(tc_plane.numpy(), jc_plane)
        jr, jxy, jm = jd.recon_points(jnp.asarray(jc_plane))
        tr, txy, tm = td.recon_points(tc_plane)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        assert _ulp_close(txy.numpy(), np.asarray(jxy))


def test_ring_ops_batched_over_streams():
    """push_ring/combine_ring over a stream axis with per-stream positions
    and push flags equal the per-stream JAX calls."""
    tc, jc = _cfgs()
    rng = np.random.default_rng(9)
    ring = np.full((3, tc.recon_window, BEAMS), EMPTY, np.int32)
    ring[:, :2] = rng.integers(0, 1 << 20, (3, 2, BEAMS))
    pos = np.asarray([2, 5, 7], np.int32)
    seg = rng.integers(0, 1 << 20, (3, BEAMS)).astype(np.int32)
    pushed = np.asarray([True, False, True])
    tr, tp = td.push_ring(*_t(ring, pos, seg, pushed))
    combined = td.combine_ring(tr, tp)
    for s in range(3):
        jr, jp = jd.push_ring(ring[s], pos[s], seg[s], pushed[s])
        np.testing.assert_array_equal(tr[s].numpy(), np.asarray(jr))
        assert int(tp[s]) == int(jp)
        np.testing.assert_array_equal(combined[s].numpy(), np.asarray(jd.combine_ring(jr, jp)))


# ---------------------------------------------------------------------------
# B4 / B5: plain versions against the JAX Pallas kernels and xla arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("beams,prof", GEOMETRIES)
def test_b4_b5_plain_match_pallas_interpret_and_xla(beams, prof):
    rng = np.random.default_rng(beams * 3 + prof)
    tc, jc = _cfgs(beams, prof)
    angle, dist, quality, valid = _rand_nodes(rng)
    # B4 at the rasterizer's shape: packed values with EMPTY for dropped nodes
    beam = np.asarray(jbeam_of(jnp.asarray(angle), beams))
    packed = np.where(valid & (dist > 0), (dist << 8) | quality, EMPTY).astype(np.int32)
    want = np.asarray(jpd.beam_min_pallas(beam, packed, beams, interpret=True))
    got = dk.beam_min_kernel(*_t(beam[None], packed[None]), beams)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jrasterize_subsweep(angle, dist, quality, valid,
                                              dataclasses.replace(jc, enable_clip=False))))
    # B5 over the shift candidates, on real profiles
    a2, d2, _q, v2 = _rand_nodes(rng)
    p1 = jref.profile_from_nodes_np(angle, dist, valid, jc)
    p2 = jref.profile_from_nodes_np(a2, d2, v2, jc)
    cands = td.shift_candidates(tc)
    np.testing.assert_array_equal(cands, jd.shift_candidates(jc))
    rolled = np.stack([np.roll(p2, int(s)) for s in cands])
    want = np.asarray(jpd.shift_sad_pallas(p1, rolled, tc.min_valid, tc.max_trans_q2,
                                           interpret=True))
    got = dk.shift_sad_kernel(*_t(p1[None], p2[None], cands), tc.min_valid,
                              tc.max_trans_q2)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_b4_b5_degenerate_inputs():
    """All EMPTY, a single node, every node in one beam, node counts off
    any block size, empty node rows: the plain versions against the JAX
    Pallas kernels (interpret mode)."""
    rng = np.random.default_rng(3)
    nb = 256
    cases = {
        "all_empty": (rng.integers(0, nb, 77), np.full(77, EMPTY)),
        "single": (np.asarray([5]), np.asarray([1234])),
        "one_beam": (np.full(513, 9), rng.integers(0, 1 << 26, 513)),
        "ragged": (rng.integers(0, nb, 1000), rng.integers(0, 1 << 26, 1000)),
    }
    for name, (beam, vals) in cases.items():
        beam, vals = beam.astype(np.int32), vals.astype(np.int32)
        want = np.asarray(jpd.beam_min_pallas(beam, vals, nb, interpret=True))
        got = dk.beam_min_kernel(*_t(beam[None], vals[None]), nb)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    empty_rows = dk.beam_min_kernel(torch.zeros((2, 0), dtype=torch.int32),
                                    torch.zeros((2, 0), dtype=torch.int32), 16)
    assert (empty_rows == EMPTY).all()
    cands = np.asarray([0, -1, 1, -2, 2], np.int32)
    for prev, cur in (
        (np.full(64, EMPTY), np.full(64, EMPTY)),
        (np.full(64, 3000), np.full(64, 3000)),           # featureless tie
        (rng.integers(0, 5000, 64), np.full(64, EMPTY)),
    ):
        prev, cur = prev.astype(np.int32), cur.astype(np.int32)
        rolled = np.stack([np.roll(cur, int(s)) for s in cands])
        want = np.asarray(jpd.shift_sad_pallas(prev, rolled, 16, 2048, interpret=True))
        got = dk.shift_sad_kernel(*_t(prev[None], cur[None], cands), 16, 2048)[0].numpy()
        np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_check_inputs_and_count_only_launches():
    dk.reset_launch_counts()
    b = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        dk.beam_min_kernel(b.to(torch.int64), b, 8)
    with pytest.raises(ValueError):
        dk.beam_min_kernel(b, b[:, :3], 8)
    with pytest.raises(ValueError):
        dk.shift_sad_kernel(b, b.t().contiguous(), torch.zeros(3, dtype=torch.int32), 1, 1)
    with pytest.raises(RuntimeError, match="no beam-min kernel"):
        dk.beam_min_kernel(b.to("meta"), b.to("meta"), 8)
    dk.beam_min_kernel(b, b, 8)  # CPU: the plain version, not a launch
    assert dk.launch_counts == {"beam_min": 0, "shift_sad": 0}


def test_backend_resolution_and_config():
    assert td.resolve_deskew_backend("auto", "cuda") == "pallas"
    assert td.resolve_deskew_backend("auto", "cpu") == "xla"
    assert td.resolve_deskew_backend("xla", "cuda") == "xla"
    with pytest.raises(ValueError):
        td.resolve_deskew_backend("auto", None)
    with pytest.raises(ValueError):
        td.DeskewConfig(recon_beams=BEAMS, backend="mosaic")
    for bad in (dict(profile_beams=48), dict(shift_window=0), dict(recon_window=1),
                dict(max_trans_q2=1 << 14), dict(recon_beams=9000)):
        with pytest.raises(ValueError):
            td.DeskewConfig(recon_beams=bad.pop("recon_beams", BEAMS), **bad)
    p = DriverParams(filter_backend="cpu", filter_chain=("clip", "median"), deskew_enable=True,
                     deskew_profile_beams=64, deskew_shift_window=4)
    cfg = td.deskew_config_from_params(p, BEAMS, platform="cuda")
    assert cfg.backend == "pallas" and cfg.enable_clip and cfg.profile_beams == 64
    assert td.deskew_config_from_params(DriverParams(), BEAMS, "cpu") is None


# ---------------------------------------------------------------------------
# the numpy twin
# ---------------------------------------------------------------------------


def test_numpy_twin_matches_jax_twin():
    tc, jc = _cfgs()
    rng = np.random.default_rng(21)
    tstream, jstream = tref.HostDeskewStream(tc), jref.HostDeskewStream(jc)
    for step in range(10):
        a, d, q, _v = _rand_nodes(rng, 300)
        a, d, q, f = jref.wire_clamp_np(a, d, q, np.zeros_like(a))
        np.testing.assert_array_equal(np.stack(tref.wire_clamp_np(a, d, q, f)),
                                      np.stack((a, d, q, f)))
        if step % 3 == 2:
            a = d = q = np.zeros((0,), np.int32)  # an idle tick
        tcomb, tpushed = tstream.tick(a, d, q)
        jcomb, jpushed = jstream.tick(a, d, q)
        assert tpushed == jpushed
        np.testing.assert_array_equal(tcomb, jcomb)
        # a drifting revolution: the estimate must move
        ra = np.sort(rng.integers(0, 65536, 400)).astype(np.int32)
        rd = (_room_profile(64)[ra * 64 // 65536] * 4 + 40 * step).astype(np.int32)
        np.testing.assert_array_equal(np.stack(tstream.revolution(ra, rd)),
                                      np.stack(jstream.revolution(ra, rd)))
        np.testing.assert_array_equal(tstream.motion, jstream.motion)
    assert (tstream.motion != 0).any()
    # the twin's blocks equal the port's tensor blocks
    a, d, q, v = _rand_nodes(rng)
    np.testing.assert_array_equal(tref.rasterize_subsweep_np(a, d, q, v, tc),
                                  td.rasterize_subsweep(*_t(a, d, q, v), tc).numpy())


# ---------------------------------------------------------------------------
# B5's redesign: far and negative shifts, the kernel's index arithmetic,
# the slimmed entry's checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [8, 37, 64, 256])
def test_b5_plain_matches_pallas_on_far_and_negative_shifts(d):
    """Shifts beyond ±D/2, at ±(D-1), ±D and beyond, on profiles with
    EMPTY beams: the plain version (the CPU arm of the wrapper) against the
    Pallas kernel in interpret mode, fed the rolls as its caller builds
    them."""
    rng = np.random.default_rng(d)
    prev = rng.integers(0, 6000, (2, d)).astype(np.int32)
    cur = rng.integers(0, 6000, (2, d)).astype(np.int32)
    prev[rng.random((2, d)) < 0.2] = EMPTY
    cur[rng.random((2, d)) < 0.2] = EMPTY
    shifts = np.asarray([0, 1, -1, d // 2 + 1, -(d // 2 + 1), d - 1, -(d - 1), d, -d, d + 1,
                         -(d + 1), 3 * d + 5, -7 * d - 3], np.int32)
    min_valid = min(4, d)
    got = dk.shift_sad_kernel(*_t(prev, cur, shifts), min_valid, 1500).numpy()
    for r in range(2):
        rolled = np.stack([np.roll(cur[r], int(s)) for s in shifts])
        want = np.asarray(jpd.shift_sad_pallas(prev[r], rolled, min_valid, 1500, interpret=True))
        np.testing.assert_array_equal(got[r], want)


def test_b5_kernel_index_arithmetic_is_the_roll():
    """csrc/deskew.cu reduces a shift once, s' = s % D (C's truncating
    remainder) plus D when negative, and reads cur[d - s'] plus D when
    negative: the roll's (d - s) mod D for every int32 shift."""
    big = np.iinfo(np.int32)
    for d in (1, 3, 37, 256, 6144):
        shifts = np.asarray([0, 1, -1, d - 1, -(d - 1), d, -d, d + 1, -(d + 1), 5 * d + 2,
                             -9 * d - 7, big.max, big.min, big.min + 1], np.int64)
        beams = np.arange(d, dtype=np.int64)
        for s in shifts:
            sh = int(np.fmod(s, d))
            sh += d if sh < 0 else 0
            assert 0 <= sh < d
            src = beams - sh
            src = np.where(src < 0, src + d, src)
            np.testing.assert_array_equal(src, np.mod(beams - s, d))


def test_b5_slim_entry_checks_as_before():
    """dtype, shape, layout, beam count and device: each wrong input raises
    on the CPU, before any plain version runs."""
    i32 = torch.int32
    p = torch.zeros((2, 64), dtype=i32)
    sh = torch.zeros(5, dtype=i32)
    for bad in ((p.to(torch.int64), p, sh), (p, p.float(), sh), (p, p, sh.to(torch.int16))):
        with pytest.raises(TypeError):
            dk.shift_sad_kernel(*bad, 1, 1)
    for bad in ((p, p[:1], sh), (p, torch.zeros((2, 65), dtype=i32), sh), (p[0], p[0], sh),
                (p, p, sh[None]), (p, torch.zeros((64, 2), dtype=i32).t(), sh),
                (p, p, torch.zeros(10, dtype=i32)[::2]),
                (torch.zeros((2, 128), dtype=i32)[:, ::2], p, sh),
                (torch.zeros((2, 0), dtype=i32),) * 2 + (sh,),
                (torch.zeros((1, dk.SHIFT_SAD_MAX_BEAMS + 1), dtype=i32),) * 2 + (sh,)):
        with pytest.raises(ValueError):
            dk.shift_sad_kernel(*bad, 1, 1)
    meta = p.to("meta")
    with pytest.raises(ValueError, match="must be on"):
        dk.shift_sad_kernel(p, meta, sh, 1, 1)
    with pytest.raises(ValueError, match="must be on"):
        dk.shift_sad_kernel(p, p, sh.to("meta"), 1, 1)
    with pytest.raises(RuntimeError, match="no shift-search kernel"):
        dk.shift_sad_kernel(meta, meta, sh.to("meta"), 1, 1)
    dk.reset_launch_counts()
    full = torch.zeros((1, dk.SHIFT_SAD_MAX_BEAMS), dtype=i32)
    assert dk.shift_sad_kernel(full, full, sh, 1, 1).shape == (1, 5)
    assert dk.shift_sad_kernel(p, p, sh[:0], 1, 1).shape == (2, 0)
    assert dk.launch_counts == {"beam_min": 0, "shift_sad": 0}


def test_b5_limits_are_the_sources():
    import re

    from rplidar_ros2_driver_tpu_torch.utils.cuda_build import CSRC_DIR

    src = (CSRC_DIR / "deskew.cu").read_text()
    assert int(re.search(r"kSadMaxBeams = (\d+) \* 1024;", src)[1]) * 1024 == \
        dk.SHIFT_SAD_MAX_BEAMS
    # the two staged profiles fit the 48 KB a block takes without opt-in
    assert 2 * dk.SHIFT_SAD_MAX_BEAMS * 4 <= 48 * 1024
    assert int(re.search(r"kSadWarps = (\d+);", src)[1]) >= 1
