"""One process over several devices: the port's ``(stream, beam)`` mesh
held in one process, on the CPU.

``make_mesh(devices=[cpu] * 8)`` is the CPU twin of the JAX suite's eight
forced host devices: eight blocks, each a separate set of tensors.  The
mesh's step and fused scan run every block's front half, sum each stream
row's voxel partials in the process (``psum`` or ``ring``), then every
block's back half.  Held here, on (2, 4), (4, 2) and (1, 8) meshes (the
step and scan cases against JAX's ``shard_map`` programs are
tests/test_torch_sharding.py's, parametrised over these meshes):

  * the placement helpers per block and the gather of the global state;
  * ``ShardedFilterService`` against the JAX service on its default mesh
    (the eight devices as (2, 4)): submit, pipelined, the host byte seam
    (config 10's host arm), the fused byte seam over the mesh's stream rows
    (each row's streams on its lead block),
    snapshots, and a restore onto another mesh shape;
  * ``save_sharded`` -> ``load_sharded`` across (2, 4) -> (1, 1) -> (4, 2);
  * ``replay_fleet`` (config 8) over eight blocks against JAX's;
  * a 2-shard pod over eight CPU cards against the JAX pod built with
    ``mesh=None`` (groups of 4), on test_torch_failover's kill case: the
    port's shards hold JAX's groups and compute on their lead cards.

Every output is bit-exact except ``points_xy``, within 2 ulp (ROADMAP
C.1), and byte-equal to the port's own (1, 1) mesh.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu import replay as jreplay
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh as jmake_mesh
from rplidar_ros2_driver_tpu_torch import replay as treplay
from rplidar_ros2_driver_tpu_torch.ops import filters as tf
from rplidar_ros2_driver_tpu_torch.parallel import service as tservice
from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

from test_torch_failover import CASES, _assert_pods_equal, _run_case
from test_torch_sharded_service import (
    BEAMS,
    CAP,
    RUN,
    _params,
    _revs,
    _scan,
    assert_same_output,
    assert_same_snapshot,
    byte_params,
    byte_ticks,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CPU = torch.device("cpu")
SHAPES = {"2x4": 2, "4x2": 4, "1x8": 1}  # mesh name -> stream extent over 8 blocks
STATE_FIELDS = ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled")


def blocks(stream: int, n: int = 8) -> ts.Mesh:
    return ts.make_mesh(devices=[CPU] * n, stream=stream)


def _jax_service(median: str) -> JService:
    """The JAX service of four streams on its (2, 4) mesh (conftest forces 8
    virtual CPU devices)."""
    return JService(_params("jax", median_backend=median), streams=4, mesh=jmake_mesh(8),
                    beams=128)


def _jax_submits(median: str) -> tuple:
    """The JAX service over ``_ticks(6)``: per tick the outputs, then the
    final snapshot."""
    jsvc = _jax_service(median)
    outs = [jsvc.submit(scans) for scans in _ticks(6)]
    return outs, {k: np.array(v) for k, v in jsvc.snapshot().items()}


@pytest.fixture(scope="module")
def jax_submits():
    """``_jax_submits`` once per module for each median backend: every mesh
    case of a median reads one run."""
    return functools.cache(_jax_submits)


@pytest.fixture(scope="module")
def jax_continued() -> dict:
    """The JAX service (``inc`` median) over ``_ticks(3)`` (then its
    snapshot and ``_copy_state()``), continued over the next three ticks
    (their outputs, then the final snapshot): once per module for the
    restore and checkpoint cases."""
    jsvc = _jax_service("inc")
    for scans in _ticks(3):
        jsvc.submit(scans)
    run = {"snapshot": {k: np.array(v) for k, v in jsvc.snapshot().items()},
           "copy_state": {k: np.array(getattr(jsvc._copy_state(), k)) for k in STATE_FIELDS}}
    run["outs"] = [jsvc.submit(scans) for scans in _ticks(6)[3:]]
    run["final"] = {k: np.array(v) for k, v in jsvc.snapshot().items()}
    return run


def _same_torch_outputs(a, b, what: str) -> None:
    assert (a is None) == (b is None), what
    if a is not None:
        for name in ("ranges", "intensities", "points_xy", "point_mask", "voxel"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)), f"{what} {name}")


# ---------------------------------------------------------------------------
# the mesh and its blocks
# ---------------------------------------------------------------------------


def test_make_mesh_holds_every_block_in_the_process():
    mesh = blocks(2)
    assert mesh.shape == {"stream": 2, "beam": 4} and mesh.multi_block
    assert not mesh.spans_processes and mesh.beam_group is None
    assert mesh.device == CPU and mesh.devices.shape == (2, 4)
    views = mesh.blocks
    assert [v.coords for v in views] == [(i, j) for i in range(2) for j in range(4)]
    assert all(not v.multi_block and v.blocks == [v] and v.shape == mesh.shape for v in views)
    assert mesh.local_streams(4) == slice(0, 4) and mesh.local_beams(128) == slice(0, 128)
    assert views[6].local_streams(4) == slice(2, 4)
    assert views[6].local_beams(128) == slice(64, 96)
    # the squarest default, a cut list, and the one-block forms
    assert ts.make_mesh(devices=[CPU] * 8).shape == {"stream": 2, "beam": 4}
    assert ts.make_mesh(4, devices=[CPU] * 8).shape == {"stream": 2, "beam": 2}
    assert ts.make_mesh(devices=["cpu"], stream=1).blocks[0].device == CPU
    one = ts.make_mesh(device=CPU)
    assert not one.multi_block and one.blocks == [one]
    with pytest.raises(ValueError, match="only 8 available"):
        ts.make_mesh(9, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="does not divide"):
        ts.make_mesh(devices=[CPU] * 8, stream=3)
    with pytest.raises(ValueError, match="not divisible by beam axis"):
        ts.build_sharded_step(blocks(1, 3), tf.FilterConfig(beams=128))
    assert "devices=" in repr(mesh)


@pytest.mark.parametrize("mesh_name", list(SHAPES))
def test_block_placement_and_gather(mesh_name):
    """create/place/shard_batch give one entry a block, each with its own
    tensors; gather_state puts the global state back together."""
    mesh = blocks(SHAPES[mesh_name])
    cfg = tf.FilterConfig(window=4, beams=128, grid=16, median_backend="inc")
    rng = np.random.default_rng(3)
    snap = {
        "range_window": rng.random((4, 4, 128), dtype=np.float32),
        "inten_window": rng.random((4, 4, 128), dtype=np.float32),
        "hit_window": rng.integers(0, 9, (4, 4, 16, 16)).astype(np.int32),
        "voxel_acc": rng.integers(0, 9, (4, 16, 16)).astype(np.int32),
        "cursor": np.arange(4, dtype=np.int32),
        "filled": np.full(4, 4, np.int32),
        "median_sorted": None,
    }
    placed = ts.place_state(mesh, snap)
    assert isinstance(placed, list) and len(placed) == 8
    ptrs = {st.range_window.data_ptr() for st in placed}
    assert len(ptrs) == 8  # a separate set of tensors a block
    got = ts.gather_state(mesh, placed)
    assert set(got) == set(STATE_FIELDS)
    for k in STATE_FIELDS:
        np.testing.assert_array_equal(got[k], snap[k], k)
    fresh = ts.create_sharded_state(mesh, cfg, 4)
    one = ts.create_sharded_state(ts.make_mesh(device=CPU), cfg, 4)
    whole = ts.gather_state(mesh, fresh)
    for k, v in ts.gather_state(ts.make_mesh(device=CPU), one).items():
        np.testing.assert_array_equal(whole[k], v, k)
    seq = np.zeros((4, 3, 8), np.uint16)
    counts = np.arange(4, dtype=np.int32)
    rows = ts.shard_batch(mesh, tf._unpack_compact(torch.from_numpy(seq.view(np.int16)),
                                                   torch.from_numpy(counts)))
    assert [r.count.tolist() for r in rows] == [
        counts[v.local_streams(4)].tolist() for v in mesh.blocks]


@pytest.mark.parametrize("reduce", ["psum", "ring"])
@pytest.mark.parametrize("mesh_name", list(SHAPES))
def test_reduce_blocks_sums_each_stream_row(mesh_name, reduce):
    """Every block of a stream row gets the row's int32 sum (wrapping as
    int32 does), on its own device; psum and ring bit-equal."""
    mesh = blocks(SHAPES[mesh_name])
    rng = np.random.default_rng(7)
    parts = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (2, 3, 3), dtype=np.int64)
                              .astype(np.int32)) for _ in range(8)]
    want = [p.clone() for p in parts]
    got = ts.reduce_blocks(mesh, [p.clone() for p in parts], reduce)
    nb = mesh.shape["beam"]
    for i in range(mesh.shape["stream"]):
        row = np.sum([w.numpy().astype(np.int64) for w in want[i * nb:(i + 1) * nb]], axis=0)
        row = ((row + 2**31) % 2**32 - 2**31).astype(np.int32)
        for j in range(nb):
            np.testing.assert_array_equal(got[i * nb + j].numpy(), row, f"{i},{j}")
    with pytest.raises(ValueError, match="unknown voxel_reduce"):
        ts.reduce_blocks(mesh, parts, "tree")


def test_peer_copy_counts_only_moves_between_devices(monkeypatch):
    """peer_copy hands back a tensor already on its device and counts no
    copy; a move to another device is one counted, contiguous copy."""
    monkeypatch.setattr(ts, "peer_copies", 0)
    x = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    assert ts.peer_copy(x, CPU) is x and ts.peer_copies == 0
    got = ts.peer_copy(x.t(), torch.device("meta"))
    assert got.device.type == "meta" and got.shape == (3, 2) and ts.peer_copies == 1


# ---------------------------------------------------------------------------
# the service on a mesh held in one process
# ---------------------------------------------------------------------------


def _ticks(n: int, streams: int = 4) -> list:
    return [[None if (s + k) % 5 == 3 else _scan(100 * s + k) for s in range(streams)]
            for k in range(n)]


@pytest.mark.parametrize("median", ["xla", "inc"])
@pytest.mark.parametrize("mesh_name", list(SHAPES))
def test_service_on_blocks_matches_jax_and_the_one_block_mesh(mesh_name, median, jax_submits):
    """submit over 6 ticks with idle streams, against the JAX service on its
    (2, 4) mesh and the port's (1, 1) mesh; snapshots equal."""
    jrun, jsnap = jax_submits(median)
    svc = ShardedFilterService(_params(median_backend=median), streams=4,
                               mesh=blocks(SHAPES[mesh_name]), beams=128)
    one = ShardedFilterService(_params(median_backend=median), streams=4,
                               mesh=ts.make_mesh(device=CPU), beams=128)
    svc.precompile()
    for k, (scans, jouts) in enumerate(zip(_ticks(6), jrun)):
        outs, ones = svc.submit(scans), one.submit(scans)
        for s in range(4):
            assert_same_output(jouts[s], outs[s], f"tick {k} stream {s}")
            _same_torch_outputs(ones[s], outs[s], f"tick {k} stream {s} (1, 1)")
    assert_same_snapshot(svc.snapshot(), jsnap)
    assert_same_snapshot(svc.snapshot(), one.snapshot())
    if median == "inc":
        for st in svc._state:
            np.testing.assert_array_equal(st.median_sorted.numpy(),
                                          np.sort(st.range_window.numpy(), axis=1))


@pytest.mark.parametrize("reduce", ["psum", "ring"])
def test_service_pipelined_and_local_on_blocks(reduce, jax_submits):
    """submit_pipelined is submit shifted by one tick, flush drains the
    last, submit_local is submit; both reduces (a FilterConfig choice, set
    on each service's config)."""
    mesh = blocks(2)
    svc = ShardedFilterService(_params(), streams=4, mesh=mesh, beams=128)
    local = ShardedFilterService(_params(), streams=4, mesh=mesh, beams=128)
    for s in (svc, local):
        s.cfg = dataclasses.replace(s.cfg, voxel_reduce=reduce)
    ticks = _ticks(5)
    # the default median backend is "inc" on the CPU, in both packages
    ref = jax_submits("inc")[0][:5]
    piped = [svc.submit_pipelined(t) for t in ticks]
    assert piped[0] == [None] * 4
    for k in range(1, len(ticks)):
        for a, b in zip(piped[k], ref[k - 1]):
            assert_same_output(b, a, f"tick {k}")
    for a, b in zip(svc.flush_pipelined(), ref[-1]):
        assert_same_output(b, a, "flush")
    for k, t in enumerate(ticks):
        for a, b in zip(local.submit_local(t), ref[k]):
            assert_same_output(b, a, f"local tick {k}")


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("backend", ["host", "fused"])
def test_byte_seams_on_blocks_match_jax(backend, pipelined):
    """Config 10's byte seams at their smoke geometry with 4 streams: the
    host arm's lockstep tick split over (2, 4) blocks, the fused engine's
    streams split over the mesh's two rows (each on its lead block), each
    against the JAX service's same arm on its default mesh."""
    kw = dict(beams=BEAMS, capacity=CAP)
    if backend == "fused":
        kw["fleet_ingest_buckets"] = (RUN,)
    jsvc = JService(byte_params("jax", backend), 4, mesh=jmake_mesh(8), **kw)
    svc = ShardedFilterService(byte_params("torch", backend), 4, mesh=blocks(2), **kw)
    published = 0
    for k, tick in enumerate(byte_ticks(4, idle={(2, 1), (5, 3)})):
        outs = svc.submit_bytes(tick, pipelined=pipelined)
        jouts = jsvc.submit_bytes(tick, pipelined=pipelined)
        for s, (j, t) in enumerate(zip(jouts, outs)):
            assert_same_output(j, t, f"tick {k} stream {s}")
            published += t is not None
    assert published >= 12
    if backend == "fused":
        eng = svc.fleet_ingest
        assert [(r.block, r.device, r.lanes) for r in eng.rows] == [
            ((0, 0), CPU, slice(0, 2)), ((1, 0), CPU, slice(2, 4))]
        assert [st.partial.shape[0] for st in eng._states] == [2, 2]
        assert svc.fleet_ingest.dispatch_count == jsvc.fleet_ingest.dispatch_count
    elif not pipelined:
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())


@pytest.mark.parametrize("target", ["1x1", "4x2", "1x8"])
def test_service_restore_onto_another_mesh_shape(target, jax_continued):
    """A (2, 4) service's snapshot restored onto another mesh shape (and
    JAX's onto the port's blocks), both continued byte-equal to JAX."""
    jrun = jax_continued
    svc = ShardedFilterService(_params(median_backend="inc"), streams=4, mesh=blocks(2),
                               beams=128)
    for scans in _ticks(3):
        svc.submit(scans)
    mesh = ts.make_mesh(device=CPU) if target == "1x1" else blocks(SHAPES[target])
    moved = ShardedFilterService(_params(median_backend="inc"), streams=4, mesh=mesh, beams=128)
    assert moved.restore(svc.snapshot())
    from_jax = ShardedFilterService(_params(median_backend="inc"), streams=4, mesh=mesh,
                                    beams=128)
    assert from_jax.restore({k: v.copy() for k, v in jrun["snapshot"].items()})
    for k, (scans, jouts) in enumerate(zip(_ticks(6)[3:], jrun["outs"])):
        for svc_ in (moved, from_jax):
            for s, (j, t) in enumerate(zip(jouts, svc_.submit(scans))):
                assert_same_output(j, t, f"continued tick {k} stream {s}")
    assert_same_snapshot(moved.snapshot(), jrun["final"])


def test_checkpoints_across_mesh_shapes(tmp_path, jax_continued):
    """save_sharded on (2, 4) blocks writes the (1, 1) mesh's global
    layout — what JAX saves, JAX's ``_copy_state()`` — and loads onto
    (1, 1), whose save loads onto (4, 2); each continued byte-equal."""
    from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded as cs

    jrun = jax_continued
    svc = ShardedFilterService(_params(median_backend="inc"), streams=4, mesh=blocks(2),
                               beams=128)
    for scans in _ticks(3):
        svc.submit(scans)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    svc.save_sharded(a)
    assert set(cs.saved_geometry(a)) == set(STATE_FIELDS)  # median_sorted never saved
    saved = cs.restore_sharded(a, ts.abstract_sharded_state(ts.make_mesh(device=CPU), svc.cfg, 4),
                               device="cpu")
    for k in STATE_FIELDS:
        w = jrun["copy_state"][k]
        got = saved[k].numpy()
        assert got.dtype == w.dtype and got.shape == w.shape, k
        np.testing.assert_array_equal(got, w, k)
    one = ShardedFilterService(_params(median_backend="inc"), streams=4,
                               mesh=ts.make_mesh(device=CPU), beams=128)
    assert one.load_sharded(a)
    assert_same_snapshot(one.snapshot(), jrun["snapshot"])
    one.save_sharded(b)
    back = ShardedFilterService(_params(median_backend="inc"), streams=4, mesh=blocks(4),
                                beams=128)
    assert back.load_sharded(b)
    for st in back._state:
        np.testing.assert_array_equal(st.median_sorted.numpy(),
                                      np.sort(st.range_window.numpy(), axis=1))
    for k, (scans, jouts) in enumerate(zip(_ticks(6)[3:], jrun["outs"])):
        for svc_ in (svc, one, back):
            for s, (j, t) in enumerate(zip(jouts, svc_.submit(scans))):
                assert_same_output(j, t, f"continued tick {k} stream {s}")
    other = ShardedFilterService(_params(filter_window=8), streams=4, mesh=blocks(2), beams=128)
    before = other.snapshot()
    assert not other.load_sharded(a)  # another window: rejected, state untouched
    assert_same_snapshot(other.snapshot(), before)


# ---------------------------------------------------------------------------
# config 8 and the pod
# ---------------------------------------------------------------------------


def replay_captures() -> list:
    """Four captures of unequal length."""
    return [_revs(1, 11), _revs(2, 9), _revs(3, 14), _revs(4, 10)]


REPLAY_KW = dict(beams=256, capacity=512, chunk=4)


@pytest.fixture(scope="module")
def jax_replay():
    """JAX's replay of the four captures on its own default mesh, once per
    module for both of the port's median backends (JAX's ``xla``): the
    ranges and the final state's fields."""
    jr, jstate = jreplay.replay_fleet(replay_captures(), _params("jax", median_backend="xla"),
                                      **REPLAY_KW)
    return np.asarray(jr), {k: np.asarray(getattr(jstate, k)) for k in STATE_FIELDS}


@pytest.mark.parametrize("median", ["pallas", "inc"])
def test_replay_fleet_over_blocks_matches_jax(median, jax_replay):
    """Four captures of unequal length, chunks of 4, over (2, 4) blocks:
    ranges and the final state bit-exact against JAX's replay on its own
    default mesh and byte-equal to the port's (1, 1) replay."""
    fleet, kw = replay_captures(), REPLAY_KW
    jr, jstate = jax_replay
    tr, tstate = treplay.replay_fleet(fleet, _params(median_backend=median), mesh=blocks(2), **kw)
    one, ostate = treplay.replay_fleet(fleet, _params(median_backend=median), **kw)
    assert tr.shape == (4, 9, 256)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(tr, one)
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), jstate[name], name)
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      getattr(ostate, name).numpy(), name)
    assert (tstate.median_sorted is not None) == (median == "inc")


@pytest.mark.parametrize("streams, beams, devices, want", [
    (8, 2048, 4, (4, 4)), (4, 2048, 6, (4, 4)), (3, 2048, 8, (8, 1)), (6, 6, 8, (6, 6)),
    (1, 2048, 1, (1, 1)),
])
def test_fleet_mesh_split_is_the_jax_rule(streams, beams, devices, want):
    assert treplay.fleet_mesh_split(streams, beams, devices) == want


def test_pod_of_two_shards_over_four_cards_each_matches_the_jax_pod(monkeypatch):
    """test_torch_failover's kill case as a 2-shard pod (shard 1 killed over
    ticks 10-12) over eight cards (CPU stand-ins): the port's shards hold
    the JAX pod's ``mesh=None`` groups of 4 and compute on their lead
    cards; every output, event, replay plan and map row equal, the guarded
    loop clean."""
    case = dict(CASES["kill_evacuate_readmit"], shards=2, over=dict(shard_count=2))
    monkeypatch.setattr(tservice, "_pod_cards", lambda params: [CPU] * 8)
    j = _run_case("jax", case)
    t = _run_case("torch", case)
    jpod, tpod = j["pod"], t["pod"]
    jgroups = [[int(d.id) for d in m.devices.flat] for m in jpod.meshes]
    assert tpod.groups == jgroups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert all(not m.multi_block and m.device == CPU for m in tpod.meshes)
    assert tpod.evacuations == 1 and tpod.readmits == 1
    _assert_pods_equal(j, t)
