"""The (stream, beam) mesh of the PyTorch package against the JAX package.

The port's one-process ``(1, 1)`` mesh runs the batched sharded step and
the fused fleet scan on the CPU (the median kernels' plain versions);
the JAX package runs its ``shard_map`` programs on (2, 4), (4, 2) and
(1, 8) meshes of the 8 forced CPU devices.  Every output and final-state
field is bit-exact, except ``points_xy``: within 2 ulp (the port's trig
table is correctly rounded, JAX's f32 cos/sin may sit one ulp off it).
Beam extents above 1 on the port's side run through gloo in
tests/test_torch_multiprocess.py.  Also ``FleetTopology`` (a copy)
against the JAX package's on one scripted placement sequence.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops import filters as jf
from rplidar_ros2_driver_tpu.parallel import sharding as js
from rplidar_ros2_driver_tpu_torch.ops import filters as tf
from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CPU = torch.device("cpu")
W, B, G, CELL = 8, 512, 64, 0.25
STREAMS, CAP = 4, 400
STATE_FIELDS = ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled")


def ulp_distance(a, b) -> np.ndarray:
    """Elementwise distance in float32 units in the last place."""

    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def rand_scan(rng, n: int) -> dict:
    """A ragged revolution: random angles, drop-outs (dist 0), points
    outside the clip range, random quality."""
    dist = rng.integers(0, 60_000, n).astype(np.int32)
    dist[rng.random(n) < 0.1] = 0
    return {
        "angle_q14": rng.integers(0, 1 << 16, n).astype(np.int32),
        "dist_q2": dist,
        "quality": rng.integers(0, 256, n).astype(np.int32),
        "flag": rng.integers(0, 4, n).astype(np.int32),
    }


def fleet_ticks(seed: int, ticks: int) -> list:
    """Per tick, per stream: a scan or None (idle); stream 1 idles every
    third tick, stream 3 every other."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        row = []
        for s in range(STREAMS):
            idle = (s == 1 and t % 3 == 2) or (s == 3 and t % 2 == 1)
            row.append(None if idle else rand_scan(rng, int(rng.integers(150, CAP))))
        out.append(row)
    return out


def packed_tick(row) -> tuple[np.ndarray, np.ndarray]:
    """(S, 3, CAP) uint16 packed scans and (S,) counts (0 = idle)."""
    seq = np.zeros((len(row), 3, CAP), np.uint16)
    counts = np.zeros((len(row),), np.int32)
    for i, scan in enumerate(row):
        if scan is not None:
            seq[i], counts[i] = tf.pack_host_scan_compact(
                scan["angle_q14"], scan["dist_q2"], scan["quality"], scan["flag"], CAP)
    return seq, counts


def jax_batch(seq, counts):
    return jax.vmap(jf._unpack_compact)(jnp.asarray(seq), jnp.asarray(counts))


def torch_batch(seq, counts):
    return tf._unpack_compact(torch.from_numpy(seq.view(np.int16)), torch.from_numpy(counts))


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_out_equal(jo, to, what: str) -> None:
    for name in ("ranges", "intensities", "point_mask", "voxel"):
        np.testing.assert_array_equal(np_(getattr(jo, name)), np_(getattr(to, name)),
                                      f"{what}: {name}")
    assert ulp_distance(np_(jo.points_xy), np_(to.points_xy)).max() <= 2, what


def assert_state_equal(jstate, tstate, what: str, sorted_window: bool = False) -> None:
    names = STATE_FIELDS + (("median_sorted",) if sorted_window else ())
    for name in names:
        np.testing.assert_array_equal(np_(getattr(jstate, name)), np_(getattr(tstate, name)),
                                      f"{what}: {name}")


@pytest.fixture(scope="module")
def port_mesh():
    return ts.make_mesh(device=CPU)


MESHES = {"2x4": (8, 2), "4x2": (8, 4), "1x8": (8, 1)}


@pytest.mark.parametrize("reduce", ["psum", "ring"])
@pytest.mark.parametrize("median", ["sort", "inc"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_step_matches_jax_sharded_step(mesh_name, median, reduce, port_mesh):
    """12 ticks with idle streams: the port's one-launch-per-tick batched
    step (both median arms: ``xla`` and ``pallas`` — B1's plain version —
    for the sort backend, ``inc`` for the incremental one) against JAX's
    shard_map step on a (stream, beam) mesh of 8 CPU devices."""
    n, stream = MESHES[mesh_name]
    jmesh = js.make_mesh(n, stream=stream)
    jmed = "xla" if median == "sort" else "inc"
    jcfg = jf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL, median_backend=jmed,
                           voxel_reduce=reduce)
    jstep = js.build_sharded_step(jmesh, jcfg)
    jstate = js.create_sharded_state(jmesh, jcfg, STREAMS)
    tmeds = ("xla", "pallas") if median == "sort" else ("inc",)
    runs = {}
    for tmed in tmeds:
        tcfg = tf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL, median_backend=tmed,
                               voxel_reduce=reduce)
        runs[tmed] = [ts.build_sharded_step(port_mesh, tcfg),
                      ts.create_sharded_state(port_mesh, tcfg, STREAMS)]
    for t, row in enumerate(fleet_ticks(11, 12)):
        seq, counts = packed_tick(row)
        jstate, jout = jstep(jstate, js.shard_batch(jmesh, jax_batch(seq, counts)))
        for tmed, run in runs.items():
            run[1], tout = run[0](run[1], torch_batch(seq, counts))
            assert_out_equal(jout, tout, f"{mesh_name} {tmed} tick {t}")
    for tmed, (_step, tstate) in runs.items():
        assert_state_equal(jstate, tstate, f"{mesh_name} {tmed}", sorted_window=median == "inc")


def scan_fixture(seed: int, k: int):
    """Per stream, K packed scans with some idle (count 0) slots."""
    ticks = fleet_ticks(seed, k)
    seqs = np.zeros((STREAMS, k, 3, CAP), np.uint16)
    counts = np.zeros((STREAMS, k), np.int32)
    for t, row in enumerate(ticks):
        seqs[:, t], counts[:, t] = packed_tick(row)
    return seqs, counts


@pytest.mark.parametrize("median", ["pallas", "xla", "inc"])
def test_scan_matches_jax_sharded_scan_and_k_steps(median, port_mesh):
    """The fused fleet scan — one sliding-median call (B3's plain version
    for ``pallas``) over the (W+K, S*B) history stripe per chunk — over a
    K < W chunk then a K > W chunk: equal to JAX's sharded scan on a
    (2, 4) mesh, and to K successive steps of the port's own step."""
    seqs, counts = scan_fixture(5, 13)
    jmesh = js.make_mesh(8, stream=2)
    jcfg = jf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL,
                           median_backend="inc" if median == "inc" else "xla")
    tcfg = tf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL, median_backend=median)
    jscan = js.build_sharded_scan(jmesh, jcfg)
    jstate = js.create_sharded_state(jmesh, jcfg, STREAMS)
    tscan = ts.build_sharded_scan(port_mesh, tcfg)
    tstate = ts.create_sharded_state(port_mesh, tcfg, STREAMS)
    tstep = ts.build_sharded_step(port_mesh, tcfg)
    sstate = ts.create_sharded_state(port_mesh, tcfg, STREAMS)
    for lo, hi in ((0, 3), (3, 13)):
        jstate, jr = jscan(jstate, jnp.asarray(seqs[:, lo:hi]), jnp.asarray(counts[:, lo:hi]))
        tstate, tr = tscan(tstate, seqs[:, lo:hi], counts[:, lo:hi])
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy(), f"chunk {lo}:{hi}")
        for k in range(lo, hi):
            sstate, sout = tstep(sstate, torch_batch(seqs[:, k], counts[:, k]))
            np.testing.assert_array_equal(tr[:, k - lo].numpy(), sout.ranges.numpy(), f"step {k}")
    assert_state_equal(jstate, tstate, "jax vs scan")
    assert_state_equal(tstate, sstate, "scan vs steps")
    if median == "inc":
        np.testing.assert_array_equal(tstate.median_sorted.numpy(), sstate.median_sorted.numpy())


def test_scan_of_one_stream_equals_compact_filter_scan(port_mesh):
    """A one-stream fleet scan is the single-stream fused chain."""
    seqs, counts = scan_fixture(8, 9)
    cfg = tf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL, median_backend="pallas")
    state, ranges = ts.build_sharded_scan(port_mesh, cfg)(
        ts.create_sharded_state(port_mesh, cfg, 1), seqs[:1], counts[:1])
    ref_state, ref = tf.compact_filter_scan(
        tf.FilterState.for_config(cfg, device=CPU),
        torch.from_numpy(seqs[0].view(np.int16)), torch.from_numpy(counts[0]), cfg)
    np.testing.assert_array_equal(ranges[0].numpy(), ref.numpy())
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(state, name)[0].numpy(),
                                      getattr(ref_state, name).numpy(), name)


def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = ts.make_mesh(device=CPU)
    assert mesh.shape == {"stream": 1, "beam": 1} and mesh.device == CPU
    assert not mesh.spans_processes and mesh.beam_group is None and mesh.coords == (0, 0)
    assert ts.make_mesh(1, stream=1, device="cpu").shape == {"stream": 1, "beam": 1}
    with pytest.raises(ValueError, match="only 1 available"):
        ts.make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="does not divide"):
        ts.make_mesh(1, stream=2, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.make_mesh()  # the card by default, never a silent host fallback
    with pytest.raises(ValueError, match="unknown voxel_reduce"):
        ts.build_sharded_step(mesh, tf.FilterConfig(beams=B, voxel_reduce="tree"))
    with pytest.raises(ValueError, match="not divisible by beam axis"):
        ts.build_sharded_scan(ts.Mesh(1, 3, CPU), tf.FilterConfig(beams=B))
    with pytest.raises(ValueError, match="not divisible by stream axis"):
        ts.Mesh(2, 1, CPU).local_streams(3)
    with pytest.raises(ValueError, match="not divisible by beam axis"):
        ts.Mesh(1, 3, CPU).local_beams(B)


def test_placement_helpers(port_mesh):
    """place_state takes the JAX package's stream-batched state (or its
    snapshot dict) as this process's block, COPIED; shard_batch takes a
    batch's local rows; the sharded checkpoints' restore template is JAX's
    abstract state (global shapes and dtypes, no median_sorted) as meta
    tensors."""
    jcfg = jf.FilterConfig(window=W, beams=B, grid=G, cell_m=CELL)
    jstate = js.create_sharded_state(js.make_mesh(8, stream=2), jcfg, STREAMS)
    snap = {k: np.array(getattr(jstate, k)) for k in STATE_FIELDS}
    placed = ts.place_state(port_mesh, snap)
    placed.range_window.fill_(1.0)
    assert np.isinf(snap["range_window"]).all()  # the caller's buffer is untouched
    half = ts.Mesh(2, 2, CPU, coords=(1, 1))
    block = ts.place_state(half, snap)
    assert tuple(block.range_window.shape) == (STREAMS // 2, W, B // 2)
    assert tuple(block.hit_window.shape) == (STREAMS // 2, W, G, G)
    assert block.cursor.dtype == torch.int32 and block.median_sorted is None
    seq, counts = packed_tick(fleet_ticks(3, 1)[0])
    rows = ts.shard_batch(half, torch_batch(seq, counts))
    np.testing.assert_array_equal(rows.count.numpy(), counts[2:])
    jtmpl = js.abstract_sharded_state(js.make_mesh(8, stream=2), jcfg, STREAMS)
    tmpl = ts.abstract_sharded_state(half, tf.FilterConfig(window=W, beams=B, grid=G,
                                                            cell_m=CELL), STREAMS)
    for f in STATE_FIELDS:
        want, got = getattr(jtmpl, f), getattr(tmpl, f)
        assert tuple(got.shape) == tuple(want.shape) and got.device.type == "meta", f
        assert str(got.dtype).split(".")[-1] == str(want.dtype), f
    assert jtmpl.median_sorted is None and tmpl.median_sorted is None
    with pytest.raises(ValueError, match="not divisible by stream axis"):
        ts.abstract_sharded_state(ts.Mesh(3, 1, CPU), tf.FilterConfig(), STREAMS)


def _topology_script(mod):
    """One scripted assign/evacuate/rebalance sequence; every observable
    after each step."""
    trace = []
    topo = mod.FleetTopology(streams=7, shards=4, lanes=3, hosts=2)
    trace.append(topo.status())
    topo.set_weights({0: 3.0, 4: 2.5, 5: 0.0})
    topo.set_weight(2, 1.5)
    trace.append([topo.coordinate(s) for s in range(7)])
    trace.append(topo.evacuate(1))
    trace.append((topo.status(), topo.unhosted()))
    trace.append(topo.evacuate(3, avoid=[1]))
    trace.append((topo.status(), topo.unhosted(), [topo.lane_streams(s) for s in range(4)]))
    trace.append(topo.rebalance_into(1))
    trace.append(topo.rebalance_into(3))
    topo.release(6)
    trace.append(topo.assign(6, prefer_host=1))
    trace.append((topo.status(), topo.lane_items(2, list("abcdefg")), topo.host_load(0),
                  topo.shards_on_host(1), [topo.placement(s) for s in range(7)]))
    for bad in (lambda: mod.FleetTopology(4, 2, 1), lambda: mod.FleetTopology(4, 3, 2, hosts=2),
                lambda: topo.host_of(9), lambda: topo.assign(0)):
        try:
            bad()
            trace.append(None)
        except (ValueError, IndexError) as e:
            trace.append((type(e).__name__, str(e)))
    return trace


def test_fleet_topology_matches_jax():
    assert _topology_script(ts) == _topology_script(js)
