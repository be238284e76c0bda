"""The port's pose-graph solver against the JAX package's.

``rplidar_ros2_driver_tpu_torch/ops/pose_graph.py`` (batched over streams)
and its numpy twin ``ops/pose_graph_ref.py`` are held byte-equal to the
JAX package's ``solve_pose_graph`` / ``fleet_solve_pose_graph`` and its
``pose_graph_ref`` on seeded random graphs: padding rows, out-of-range
indices, clamped z terms and weights, a single node, no constraints.  The
tolerance is byte equality throughout (every value is int32).
"""

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops import pose_graph as jpg
from rplidar_ros2_driver_tpu.ops import pose_graph_ref as jref
from rplidar_ros2_driver_tpu_torch.ops import pose_graph as tpg
from rplidar_ros2_driver_tpu_torch.ops import pose_graph_ref as tref
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, rotation_table
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def cfgs(**kw):
    return jpg.PoseGraphConfig(**kw), tpg.PoseGraphConfig(**kw)


def random_graph(rng, s: int, m: int, c: int, fill: int):
    """S seeded graphs: nodes anywhere in ±4000 subcells, node 0 at the
    origin; ``fill`` live rows with some indices out of range (clipped),
    some z terms past the clamp, some weights 0 (padding) or past
    weight_max; the rest padding."""
    nodes = rng.integers(-4000, 4000, (s, m, 3)).astype(np.int32)
    nodes[..., 2] = rng.integers(0, 720, (s, m))
    nodes[:, 0] = 0
    cons = np.zeros((s, c, 6), np.int32)
    cons[:, :fill, 0] = rng.integers(-2, m + 2, (s, fill))
    cons[:, :fill, 1] = rng.integers(-2, m + 2, (s, fill))
    cons[:, :fill, 2:4] = rng.integers(-20000, 20000, (s, fill, 2))
    cons[:, :fill, 4] = rng.integers(-1000, 1000, (s, fill))
    cons[:, :fill, 5] = rng.integers(0, 30, (s, fill))
    return nodes, cons


def port_solve(nodes, cons, cfg):
    return tpg.fleet_solve_pose_graph(torch.from_numpy(nodes), torch.from_numpy(cons), cfg).numpy()


@pytest.mark.parametrize("seed", range(6))
def test_random_graphs_match_jax_and_both_twins(seed):
    jc, tc = cfgs(max_nodes=8, max_constraints=24, iters=96, t_limit_sub=4096)
    rng = np.random.default_rng(seed)
    nodes, cons = random_graph(rng, 1, 8, 24, int(rng.integers(1, 24)))
    want = np.asarray(jpg.solve_pose_graph(nodes[0], cons[0], jc))
    np.testing.assert_array_equal(want, jref.solve_pose_graph_np(nodes[0], cons[0], jc))
    got = tpg.solve_pose_graph(torch.from_numpy(nodes[0]), torch.from_numpy(cons[0]), tc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tref.solve_pose_graph_np(nodes[0], cons[0], tc), want)


@pytest.mark.parametrize("streams", [1, 3, 8])
def test_fleet_batch_matches_jax_vmap(streams):
    """One sweep loop for S graphs equals the JAX package's vmapped solve,
    stream for stream (the bench's smoke geometry: 8 nodes = 8 submaps,
    8 + 32 constraint rows, 96 sweeps)."""
    jc, tc = cfgs(max_nodes=8, max_constraints=40, iters=96, t_limit_sub=32 * 32)
    rng = np.random.default_rng(100 + streams)
    nodes, cons = random_graph(rng, streams, 8, 40, 12)
    want = np.asarray(jpg.fleet_solve_pose_graph(nodes, cons, jc))
    np.testing.assert_array_equal(port_solve(nodes, cons, tc), want)


def test_no_constraints_is_the_identity():
    jc, tc = cfgs(max_nodes=8, max_constraints=24)
    rng = np.random.default_rng(1)
    nodes, _ = random_graph(rng, 2, 8, 24, 0)
    nodes[:, 0] = rng.integers(-50, 50, (2, 3))   # the anchor too stays put
    nodes[..., 2] %= 720
    cons = np.zeros((2, 24, 6), np.int32)
    np.testing.assert_array_equal(port_solve(nodes, cons, tc), nodes)
    np.testing.assert_array_equal(np.asarray(jpg.fleet_solve_pose_graph(nodes, cons, jc)), nodes)


def test_single_node_graph_keeps_its_anchor():
    jc, tc = cfgs(max_nodes=1, max_constraints=4, iters=8)
    nodes = np.asarray([[[100, -50, 3]]], np.int32)
    cons = np.zeros((1, 4, 6), np.int32)
    cons[0, 0] = [0, 0, 5, 5, 1, 4]                 # a self-loop on the gauge anchor
    got = port_solve(nodes, cons, tc)
    np.testing.assert_array_equal(got, nodes)
    np.testing.assert_array_equal(got[0], np.asarray(jpg.solve_pose_graph(nodes[0], cons[0], jc)))


def test_padding_rows_change_nothing():
    """Rows of weight 0 anywhere in the plane leave the solution alone."""
    _, tc = cfgs(max_nodes=6, max_constraints=12, iters=48)
    rng = np.random.default_rng(5)
    nodes, cons = random_graph(rng, 2, 6, 12, 6)
    cons[..., 5] = np.clip(cons[..., 5], 1, 16)
    padded = np.zeros_like(cons)
    padded[:, ::2] = cons[:, :6]
    padded[:, 1::2, :5] = rng.integers(-3, 3000, (2, 6, 5))   # weight 0
    a = port_solve(nodes, np.concatenate([cons[:, :6], np.zeros_like(cons[:, :6])], 1), tc)
    np.testing.assert_array_equal(port_solve(nodes, padded, tc), a)


def test_golden_loop_relaxes_to_lattice():
    """A 5-node chain with one cell of drift a step and a strong loop
    constraint back to the anchor relaxes the end node to within a cell."""
    _, tc = cfgs(max_nodes=8, max_constraints=24, iters=96)
    nodes = np.zeros((1, 8, 3), np.int32)
    step = 10 * SUB
    for k in range(1, 5):
        nodes[0, k] = [(step + SUB) * k, 0, 0]
    cons = np.zeros((1, 24, 6), np.int32)
    for k in range(1, 5):
        cons[0, k - 1] = [k - 1, k, step + SUB, 0, 0, 1]
    cons[0, 4] = [0, 4, 4 * step, 0, 0, 8]
    got = port_solve(nodes, cons, tc)[0]
    assert abs(int(got[4, 0]) - 4 * step) <= SUB
    assert all(got[i, 0] < got[i + 1, 0] for i in range(4))


def test_pose_helpers_match_jax():
    table = rotation_table(720)
    rng = np.random.default_rng(3)
    a = rng.integers(-20000, 20000, (4, 5, 3)).astype(np.int32)
    b = rng.integers(-20000, 20000, (4, 5, 3)).astype(np.int32)
    a[..., 2] = rng.integers(0, 720, (4, 5))
    b[..., 2] = rng.integers(-1000, 1000, (4, 5))
    tt = torch.from_numpy(table)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("pose_compose", "pose_relative"):
        want = np.asarray(getattr(jpg, name)(a, b, table, 720))
        np.testing.assert_array_equal(getattr(tpg, name)(ta, tb, tt, 720).numpy(), want, name)
        np.testing.assert_array_equal(getattr(tref, name + "_np")(a, b, table, 720), want, name)
    want = np.asarray(jpg.rel_inverse(b, table, 720))
    np.testing.assert_array_equal(tpg.rel_inverse(tb, tt, 720).numpy(), want)
    np.testing.assert_array_equal(tref.rel_inverse_np(b, table, 720), want)
    d = np.arange(-2000, 2000, 7, dtype=np.int32)
    np.testing.assert_array_equal(tpg.wrap_steps(torch.from_numpy(d), 720).numpy(),
                                  np.asarray(jpg.wrap_steps(d, 720)))


def test_config_validation_matches_jax():
    for kw in (dict(max_nodes=0, max_constraints=4), dict(max_nodes=2, max_constraints=0),
               dict(max_nodes=2, max_constraints=4, iters=0),
               dict(max_nodes=2, max_constraints=4, theta_divisions=3),
               dict(max_nodes=2, max_constraints=4, t_limit_sub=0),
               dict(max_nodes=2, max_constraints=4, weight_max=0),
               dict(max_nodes=64, max_constraints=100000, t_limit_sub=16384, weight_max=16)):
        with pytest.raises(ValueError) as jerr:
            jpg.PoseGraphConfig(**kw)
        with pytest.raises(ValueError) as terr:
            tpg.PoseGraphConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    assert tpg.POSE_GRAPH_VERSION == jpg.POSE_GRAPH_VERSION


def test_shapes_are_checked():
    _, tc = cfgs(max_nodes=4, max_constraints=4)
    with pytest.raises(ValueError, match="expected"):
        tpg.fleet_solve_pose_graph(torch.zeros((1, 5, 3), dtype=torch.int32),
                                   torch.zeros((1, 4, 6), dtype=torch.int32), tc)


# ---------------------------------------------------------------------------
# the trig gather on the device, for any index shape (a 0-d index included)
# ---------------------------------------------------------------------------

POSE_SHAPES = [(), (5,), (4, 6)]


@pytest.mark.parametrize("shape", POSE_SHAPES, ids=["0d", "n", "nk"])
def test_trig_gathers_any_index_shape(shape):
    """``_trig`` on a 0-d, (N,) and (N, K) angle: JAX's ``jnp.take`` rows
    and the numpy twin's indexing, with the index's shape, negative steps
    in [-div, 0) wrapping as ``jnp.take`` wraps them."""
    import jax.numpy as jnp

    table = rotation_table(720)
    rng = np.random.default_rng(len(shape) + 40)
    th = np.asarray(rng.integers(-720, 720, shape), np.int32)
    cos_q, sin_q = tpg._trig(torch.from_numpy(table), torch.from_numpy(th))
    assert tuple(cos_q.shape) == shape and tuple(sin_q.shape) == shape
    np.testing.assert_array_equal(cos_q.numpy(), np.asarray(jnp.take(table[:, 0], th)))
    np.testing.assert_array_equal(sin_q.numpy(), np.asarray(jnp.take(table[:, 1], th)))
    np.testing.assert_array_equal(cos_q.numpy(), table[:, 0][th])
    np.testing.assert_array_equal(sin_q.numpy(), table[:, 1][th])


@pytest.mark.parametrize("shape", POSE_SHAPES, ids=["3", "n3", "nk3"])
def test_pose_helpers_match_jax_at_every_pose_shape(shape):
    """``pose_compose``, ``pose_relative`` and ``rel_inverse`` on poses of
    shape (3,), (N, 3) and (N, K, 3) equal JAX's helpers and the numpy
    twin's, byte for byte (the (3,) case is the install's odometry leg)."""
    table = rotation_table(720)
    rng = np.random.default_rng(len(shape) + 50)
    a = rng.integers(-20000, 20000, shape + (3,)).astype(np.int32)
    b = rng.integers(-20000, 20000, shape + (3,)).astype(np.int32)
    a[..., 2] = rng.integers(0, 720, shape)
    b[..., 2] = rng.integers(-1000, 1000, shape)
    tt, ta, tb = torch.from_numpy(table), torch.from_numpy(a), torch.from_numpy(b)
    for name in ("pose_compose", "pose_relative"):
        want = np.asarray(getattr(jpg, name)(a, b, table, 720))
        got = getattr(tpg, name)(ta, tb, tt, 720).numpy()
        assert got.shape == shape + (3,), name
        np.testing.assert_array_equal(got, want, name)
        np.testing.assert_array_equal(getattr(tref, name + "_np")(a, b, table, 720), want, name)
    want = np.asarray(jpg.rel_inverse(b, table, 720))
    np.testing.assert_array_equal(tpg.rel_inverse(tb, tt, 720).numpy(), want)
    np.testing.assert_array_equal(tref.rel_inverse_np(b, table, 720), want)


@pytest.mark.parametrize("streams", [1, 3])
def test_install_after_a_single_anchor_matches_jax(streams):
    """``fleet_install_submap`` into a stream holding one anchor — the
    odometry leg from that (3,) anchor (``pose_relative`` at a 0-d
    heading) — equals JAX's install byte for byte, every stream."""
    import jax.numpy as jnp

    from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
    from rplidar_ros2_driver_tpu.mapping import mapper as jmapper
    from rplidar_ros2_driver_tpu.ops import loop_close as jlc
    from rplidar_ros2_driver_tpu.slam import loop as jloop
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
    from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
    from rplidar_ros2_driver_tpu_torch.ops import loop_close as tlc
    from rplidar_ros2_driver_tpu_torch.slam import loop as tloop

    kw = dict(filter_backend="cpu", filter_chain=("clip",), map_enable=True, map_grid=32,
              map_cell_m=0.1, loop_enable=True, loop_max_submaps=4,
              pose_graph_max_constraints=4)
    jp, tp = JParams(**kw), TParams(**kw)
    jc = jloop.loop_config_from_params(jp, jmapper.map_config_from_params(jp, 64))
    tc = tloop.loop_config_from_params(tp, tmapper.map_config_from_params(tp, 64))
    g = tc.match.grid
    rng = np.random.default_rng(60 + streams)
    st = {k: np.zeros((streams,) + v, np.int32) for k, v in tlc.LoopState.shapes(tc).items()}
    port = tlc.LoopState.from_numpy(st, "cpu")
    jst = jlc.LoopState(**{k: jnp.asarray(np.array(st[k])) for k in tlc.STATE_KEYS})
    for i in (streams - 1, streams - 1):          # the first anchor, then the leg from it
        plane = rng.integers(0, tc.match.clamp_q + 1, (g, g)).astype(np.int32)
        anchor = np.asarray([rng.integers(-900, 900), rng.integers(-900, 900),
                             rng.integers(0, 720)], np.int32)
        tlc.fleet_install_submap(port, i, torch.from_numpy(plane), torch.from_numpy(anchor), tc)
        jst = jlc.fleet_install_submap(jst, jnp.int32(i), jnp.asarray(plane),
                                       jnp.asarray(anchor), cfg=jc)
    got = port.to_numpy()
    for k in tlc.STATE_KEYS:
        want = np.asarray(getattr(jst, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert int(got["count"][streams - 1]) == 2 and got["odom"][streams - 1, 1].any()
