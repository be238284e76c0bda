"""The PyTorch ScanFilterChain against the JAX package's, on the CPU.

Both chains run with ``filter_backend: cpu`` on the same seeded
revolutions.  Every output field is bit-exact except ``points_xy``, held
to 2 ulp (the port's trig comes from a correctly rounded table; JAX's f32
cos/sin may be an ulp off it).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.filters import chain as jchain
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.filters import chain as tchain
from rplidar_ros2_driver_tpu_torch.ops import filters as tf

BEAMS = 256
CHAIN = ("clip", "polar", "median", "voxel")


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def assert_same_output(jo, to) -> None:
    for f in ("ranges", "intensities", "point_mask", "voxel"):
        np.testing.assert_array_equal(np.asarray(getattr(jo, f)), np.asarray(getattr(to, f)), err_msg=f)
    # 2 ulp: correctly rounded trig table vs JAX's f32 cos/sin
    assert ulp_distance(jo.points_xy, to.points_xy).max() <= 2


def revolutions(seed: int, n: int, points: int = 400):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        angle = np.sort(rng.integers(0, 1 << 16, points)).astype(np.int32)
        dist = (4000 * (2.0 + 0.5 * np.sin(np.arange(points) * 0.02 + 0.1 * k))
                + rng.normal(0, 40, points)).astype(np.int32)
        dist[rng.random(points) < 0.05] = 0
        dist[rng.random(points) < 0.02] = 200_000  # beyond range_max
        qual = rng.integers(0, 256, points).astype(np.int32)
        out.append((angle, dist, qual, (np.arange(points) == 0).astype(np.int32)))
    return out


def chains(median="auto", window=8, grid=64, capacity=None, **kw):
    common = dict(filter_backend="cpu", filter_window=window, filter_chain=CHAIN,
                  voxel_grid_size=grid, median_backend=median, **kw)
    return (
        jchain.ScanFilterChain(JParams(**common), beams=BEAMS, capacity=capacity),
        tchain.ScanFilterChain(TParams(**common), beams=BEAMS, capacity=capacity),
    )


def assert_same_state(jc, tc) -> None:
    js, ts = jc.snapshot(), tc.snapshot()
    assert set(js) == set(ts)
    for k in js:
        assert js[k].dtype == ts[k].dtype, k
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)


@pytest.mark.parametrize("median", ["auto", "xla", "pallas", "inc_pallas"])
def test_process_raw_matches_jax_chain(median):
    jc, tc = chains(median)
    assert tc.device == torch.device("cpu")
    for rev in revolutions(1, 12):
        assert_same_output(jc.process_raw(*rev), tc.process_raw(*rev))
    assert_same_state(jc, tc)


@pytest.mark.parametrize("cell_m", [0.25, 0.1])
def test_process_raw_pipelined_matches_jax_chain(cell_m):
    jc, tc = chains("auto", voxel_cell_m=cell_m)
    for rev in revolutions(2, 11):
        jo, to = jc.process_raw_pipelined(*rev), tc.process_raw_pipelined(*rev)
        assert (jo is None) == (to is None)
        if jo is not None:
            assert_same_output(jo, to)
    assert_same_output(jc.flush_pipelined(), tc.flush_pipelined())
    assert jc.flush_pipelined() is None and tc.flush_pipelined() is None
    assert_same_state(jc, tc)


def test_process_scanbatch_matches_jax_chain():
    from rplidar_ros2_driver_tpu.core.types import ScanBatch as JB
    from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch as TB

    jc, tc = chains("xla")
    for rev in revolutions(3, 10):
        jo = jc.process(JB.from_numpy(*rev, n=512))
        to = tc.process(TB.from_numpy(*rev, n=512, device="cpu"))
        assert_same_output(jo, tf.FilterOutput(*(t.numpy() for t in dataclasses.astuple(to))))


def test_jax_snapshot_restores_into_port_and_back():
    """A window written by one package resumes in the other: the two
    continue bit-identically from the carried state."""
    revs = revolutions(4, 20)
    jc, tc = chains("auto")
    for rev in revs[:10]:
        jc.process_raw(*rev)
    assert tc.restore(jc.snapshot())
    assert_same_state(jc, tc)
    for rev in revs[10:15]:
        assert_same_output(jc.process_raw(*rev), tc.process_raw(*rev))
    # and the reverse: the port's snapshot into a fresh JAX chain
    jc2, _ = chains("auto")
    assert jc2.restore(tc.snapshot())
    for rev in revs[15:]:
        assert_same_output(jc2.process_raw(*rev), tc.process_raw(*rev))
    assert_same_state(jc2, tc)


def test_restore_under_a_different_median_backend_recomputes_sorted_window():
    _, src = chains("xla")
    for rev in revolutions(5, 6):
        src.process_raw(*rev)
    jc, tc = chains("inc_pallas")
    assert jc.restore(src.snapshot()) and tc.restore(src.snapshot())
    np.testing.assert_array_equal(
        tc.state.median_sorted.numpy(), np.sort(src.snapshot()["range_window"], axis=0)
    )
    for rev in revolutions(6, 4):
        assert_same_output(jc.process_raw(*rev), tc.process_raw(*rev))


def test_capacity_truncation_matches_jax(caplog):
    """An oversized revolution is truncated head-keep with one warning, as
    the JAX chain does."""
    jc, tc = chains("auto", capacity=256)
    with caplog.at_level(logging.WARNING, logger="rplidar_tpu.chain"):
        for rev in revolutions(7, 4, points=400):
            assert_same_output(jc.process_raw(*rev), tc.process_raw(*rev))
    port_warnings = [r for r in caplog.records if "exceeds wire capacity" in r.getMessage()]
    assert len(port_warnings) == 2  # once per chain
    assert_same_state(jc, tc)


def test_restore_rejects_mismatched_shapes():
    _, tc = chains("auto")
    for rev in revolutions(8, 3):
        tc.process_raw(*rev)
    before = tc.snapshot()
    other, _ = chains("auto", window=4)
    assert not tc.compatible(other.snapshot())
    assert not tc.restore(other.snapshot())
    after = tc.snapshot()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    assert tchain.ScanFilterChain.snapshot_compatible(
        TParams(filter_window=8, voxel_grid_size=64), before, beams=BEAMS
    )
    assert not tchain.ScanFilterChain.snapshot_compatible(TParams(filter_window=8), before)


def test_reset_and_precompile_leave_a_fresh_state():
    _, tc = chains("inc_pallas")
    fresh = tf.FilterState.for_config(tc.cfg, device="cpu")
    for f in ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled", "median_sorted"):
        assert torch.equal(getattr(tc.state, f), getattr(fresh, f)), f
    tc.process_raw(*revolutions(9, 1)[0])
    assert int(tc.state.filled) == 1
    tc.precompile()  # skipped on a state that has absorbed scans
    assert int(tc.state.filled) == 1
    tc.reset()
    assert int(tc.state.filled) == 0 and int(tc.state.cursor) == 0


def test_reset_drops_the_pending_pipelined_output():
    _, tc = chains("auto")
    revs = revolutions(10, 3)
    assert tc.process_raw_pipelined(*revs[0]) is None
    tc.reset()
    assert tc.flush_pipelined() is None
    tc.process_raw_pipelined(*revs[1])
    tc.discard_pipelined()
    assert tc.flush_pipelined() is None


def test_resolver_table():
    r = tchain.resolve_median_backend
    assert r("auto", "cuda") == "pallas"
    assert r("auto", "cpu") == "inc"
    assert r("auto", "cuda", window=512) == "pallas"
    for explicit in ("xla", "pallas", "inc", "inc_xla", "inc_pallas"):
        assert r(explicit, "cuda") == explicit and r(explicit, "cpu") == explicit
    with pytest.raises(ValueError):
        r("auto", "tpu")
    assert tchain.resolve_resample_backend("auto", "cuda") == "scatter"
    assert tchain.resolve_voxel_backend("auto", "cuda") == "scatter"
    assert tchain.resolve_voxel_backend("matmul", "cpu") == "matmul"
    assert tchain.resolve_ingest_backend("auto") == "host"
    assert tchain.resolve_fleet_ingest_backend("auto") == "host"
    cfg = tchain.config_from_params(TParams(), platform="cuda")
    assert cfg.median_backend == "pallas"
    assert tchain.config_from_params(TParams(), platform="cpu").median_backend == "inc_xla"
    assert tchain.config_from_params(TParams(median_backend="inc"), platform="cuda").median_backend == "inc_pallas"


def test_config_from_params_matches_jax_geometry():
    p = dict(filter_window=32, voxel_grid_size=128, voxel_cell_m=0.1, filter_chain=("clip", "voxel"),
             range_clip_min_m=0.3, range_clip_max_m=12.0, intensity_min=5.0, median_backend="xla")
    j = jchain.config_from_params(JParams(**p), 1024, platform="cpu")
    t = tchain.config_from_params(TParams(**p), 1024, platform="cpu")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("backend", ["tpu", "cuda"])
def test_accelerator_backend_without_cuda_raises(backend, monkeypatch):
    """``tpu`` (the default) and ``cuda`` mean the card: with no CUDA they
    raise instead of falling back to the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="filter_backend: cpu"):
        tchain.ScanFilterChain(TParams(filter_backend=backend, filter_chain=CHAIN))
    assert tchain.pick_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        tchain.pick_device("gpu")
    with pytest.raises(ValueError):
        TParams(filter_backend="gpu").validate()


def test_snapshot_during_streaming_is_never_torn():
    """The step updates the state in place; a snapshot taken from another
    thread while the scan thread streams must see whole steps only: the
    number of ring rows written equals ``filled`` in every snapshot."""
    import sys
    import threading

    _, tc = chains("inc_pallas", window=16)
    revs = revolutions(11, 40, points=2000)  # dense: every beam hit every scan
    errors = []

    def stream():
        try:
            for rev in revs:
                tc.process_raw(*rev)
        except Exception as e:  # relayed to the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=stream)
        t.start()
        seen = []
        while t.is_alive():
            snap = tc.snapshot()
            rows = int(np.isfinite(snap["range_window"]).any(axis=1).sum())
            assert rows == int(snap["filled"])
            seen.append(int(snap["filled"]))
        t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not t.is_alive() and not errors
    assert seen == sorted(seen) and int(tc.state.filled) == 16
