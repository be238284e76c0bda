"""The PyTorch package's sharded checkpoints against the JAX package's.

``utils/checkpoint_sharded.py`` (torch.distributed.checkpoint) is the
port's counterpart of the JAX package's Orbax checkpointer.  The JAX
checkpointer's own save -> load does not round-trip with the installed
Orbax (its metadata check reads a leaf set of ``['']``), so the port is held
to two things: what JAX saves — the service's ``_copy_state()`` and the
fused FleetMapper's stacked MapState after the same ticks — and the
contracts of JAX's five ``TestOrbaxCheckpoint`` cases
(tests/test_sharded_service.py), case for case.  The restore across mesh
shapes runs in tests/test_torch_multiprocess.py's gloo workers.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.mapping import mapper as jmapper
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.ops.scan_match import MapState
from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService
from rplidar_ros2_driver_tpu_torch.utils import checkpoint_sharded as cs
from test_torch_mapper import BEAMS, jax_params, port_params, room_ticks, run
from test_torch_sharded_service import _params, _scan, jmesh, mesh  # noqa: F401  (fixtures)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STATE_KEYS = ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled")


def _service(mesh, **kw):
    return ShardedFilterService(_params(**kw), streams=2, mesh=mesh, beams=128)


def _assert_snapshots_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
        assert a[k].dtype == b[k].dtype, k


# ---------------------------------------------------------------------------
# JAX's TestOrbaxCheckpoint, case for case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("median", ["xla", "inc"])
def test_sharded_save_restore_roundtrip(mesh, tmp_path, median):
    """The restored service's blocks land on its mesh and processing agrees
    (both median backends: ``inc`` recomputes the sorted window)."""
    path = str(tmp_path / "ckpt")
    svc = _service(mesh, median_backend=median)
    svc.submit([_scan(1), _scan(2)])
    svc.save_sharded(path)

    svc2 = _service(mesh, median_backend=median)
    assert svc2.load_sharded(path)
    _assert_snapshots_equal(svc2.snapshot(), svc.snapshot())
    if median == "inc":
        np.testing.assert_array_equal(svc2._state.median_sorted, svc._state.median_sorted)
    a = svc.submit([_scan(3), _scan(4)])
    b = svc2.submit([_scan(3), _scan(4)])
    for x, y in zip(a, b):
        for name in ("ranges", "intensities", "points_xy", "voxel"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name), name)


def test_sharded_restore_rejects_wrong_geometry(mesh, tmp_path, caplog):
    path = str(tmp_path / "ckpt")
    svc = _service(mesh)
    svc.submit([_scan(1), _scan(2)])
    svc.save_sharded(path)

    other = _service(mesh, filter_window=8)
    other.submit([_scan(7), _scan(8)])
    before = other.snapshot()
    with caplog.at_level("WARNING"):
        assert not other.load_sharded(path)
    assert "leaf range_window saved as (2, 4, 128)" in caplog.text
    # absence is also a clean no-op
    assert not other.load_sharded(str(tmp_path / "missing"))
    # rejected restores left the current state untouched
    _assert_snapshots_equal(other.snapshot(), before)


def test_save_rotation_keeps_previous_on_crash_window(mesh, tmp_path):
    """A crash that strands the previous checkpoint at .old (between the two
    rotation renames): restore recovers it instead of failing."""
    path = str(tmp_path / "ckpt")
    svc = _service(mesh)
    svc.submit([_scan(1), _scan(2)])
    svc.save_sharded(path)
    shutil.move(path, path + ".old")  # the crash window

    svc2 = _service(mesh)
    assert svc2.load_sharded(path)
    _assert_snapshots_equal(svc2.snapshot(), svc.snapshot())


def test_overwrite_in_place(mesh, tmp_path):
    """Repeated saves to one path keep working and keep the newest."""
    path = str(tmp_path / "ckpt")
    svc = _service(mesh)
    svc.submit([_scan(1), _scan(2)])
    svc.save_sharded(path)
    svc.submit([_scan(3), _scan(4)])
    svc.save_sharded(path)

    svc2 = _service(mesh)
    assert svc2.load_sharded(path)
    np.testing.assert_array_equal(svc2.snapshot()["voxel_acc"], svc.snapshot()["voxel_acc"])
    assert not (tmp_path / "ckpt.old").exists() and not (tmp_path / "ckpt.saving").exists()


def test_sharded_restore_across_mesh_shapes():
    """JAX saves on (2, 4) and loads on (4, 2).  With one device a process
    the port's meshes of several shapes span processes: the gloo workers of
    tests/test_torch_multiprocess.py save on (1, 2) and (1, 4) and restore on
    (2, 1), (2, 2) and one process, bit-equal.  Here: the abstract template
    of each shape is the same global geometry, so a checkpoint of one
    restores onto the other."""
    cfg = ShardedFilterService(_params(), streams=4, mesh=ts.make_mesh(device="cpu"),
                               beams=128).cfg
    shapes = {}
    for stream, beam in ((1, 1), (2, 4), (4, 2)):
        m = ts.Mesh(stream, beam, "cpu")
        tmpl = ts.abstract_sharded_state(m, cfg, 4)
        assert tmpl.median_sorted is None
        shapes[(stream, beam)] = {k: (tuple(t.shape), t.dtype, t.device.type)
                                  for k, t in cs.as_tensor_dict(tmpl).items()}
    assert shapes[(1, 1)] == shapes[(2, 4)] == shapes[(4, 2)]
    assert {v[2] for v in shapes[(1, 1)].values()} == {"meta"}
    assert shapes[(1, 1)]["range_window"][:2] == ((4, 4, 128), torch.float32)
    with pytest.raises(ValueError, match="not divisible by stream axis"):
        ts.abstract_sharded_state(ts.Mesh(3, 1, "cpu"), cfg, 4)


# ---------------------------------------------------------------------------
# the saved content is what the JAX package saves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("median", ["xla", "inc"])
def test_saved_state_equals_the_jax_services_copy_state(jmesh, mesh, tmp_path, median):
    jsvc = JService(_params("jax", median_backend=median), streams=2, mesh=jmesh, beams=128)
    svc = _service(mesh, median_backend=median)
    for k in range(3):
        row = [_scan(2 * k + 1), None if k == 1 else _scan(2 * k + 2)]
        jsvc.submit(row)
        svc.submit(row)
    path = str(tmp_path / "ckpt")
    svc.save_sharded(path)
    geometry = cs.saved_geometry(path)
    assert set(geometry) == set(STATE_KEYS)  # median_sorted is derived, never saved
    saved = cs.restore_sharded(path, ts.abstract_sharded_state(mesh, svc.cfg, 2), device="cpu")
    want = jsvc._copy_state()
    assert want.median_sorted is None
    for k in STATE_KEYS:
        w = np.asarray(getattr(want, k))
        got = saved[k].numpy()
        assert got.dtype == w.dtype and got.shape == w.shape, k
        np.testing.assert_array_equal(got, w, k)


def test_fleet_mapper_checkpoint_matches_jax_and_continues(tmp_path, caplog):
    """The fused mapper's checkpoint holds the JAX fused mapper's stacked
    MapState after the same ticks; a restored mapper continues byte-equal
    to the uninterrupted one; another grid is rejected with the live state
    untouched; the host backend refuses, with JAX's texts."""
    ticks = room_ticks(3, BEAMS, 6)
    jm = jmapper.FleetMapper(jax_params(map_backend="fused"), 3, beams=BEAMS)
    tm = tmapper.FleetMapper(port_params(map_backend="fused"), 3, beams=BEAMS)
    run(jm, ticks[:4])
    run(tm, ticks[:4])
    path = str(tmp_path / "map")
    tm.save_sharded(path)
    saved = cs.restore_sharded(path, MapState.create(tm.cfg, 3, "meta"), device="cpu")
    for k in ("log_odds", "pose", "origin_xy", "revision"):
        w = np.asarray(getattr(jm._states, k))
        assert saved[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(saved[k].numpy(), w, k)

    fresh = tmapper.FleetMapper(port_params(map_backend="fused"), 3, beams=BEAMS)
    assert fresh.load_sharded(path)
    assert run(fresh, ticks[4:]) == run(tm, ticks[4:])
    for k, v in tm.snapshot().items():
        np.testing.assert_array_equal(fresh.snapshot()[k], v, k)

    wide = tmapper.FleetMapper(port_params(map_backend="fused", map_grid=32), 3, beams=BEAMS)
    run(wide, ticks[:1])
    before = wide.snapshot()
    with caplog.at_level("WARNING"):
        assert not wide.load_sharded(path)
    assert "leaf log_odds saved as (3, 64, 64)" in caplog.text
    for k, v in before.items():
        np.testing.assert_array_equal(wide.snapshot()[k], v, k)
    assert not wide.load_sharded(str(tmp_path / "absent"))

    host = tmapper.FleetMapper(port_params(map_backend="host"), 3, beams=BEAMS)
    with pytest.raises(RuntimeError, match="save_sharded needs the fused backend"):
        host.save_sharded(path)
    with pytest.raises(RuntimeError, match="load_sharded needs the fused backend"):
        host.load_sharded(path)


def test_a_checkpoint_with_a_dtype_drift_is_rejected_before_loading(tmp_path):
    """DCP would load a float32 tensor into an int32 target by conversion:
    the metadata check rejects it first."""
    path = str(tmp_path / "ck")
    cs.save_sharded(path, {"a": torch.arange(6, dtype=torch.float32)})
    assert cs.restore_sharded(path, {"a": torch.empty(6, dtype=torch.int32)}) is None
    got = cs.restore_sharded(path, {"a": torch.empty(6, dtype=torch.float32, device="meta")},
                             device="cpu")
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(6, dtype=np.float32))
    assert cs.restore_sharded(path, {"a": torch.empty(6), "b": torch.empty(1)}) is None
