"""The port's shared-world plane (ops/tile_quant, mapping/tiles,
mapping/worldmap) against the JAX package's.

Byte equality throughout (int32 planes, integer codings): the tile coding
and the fusion ops on seeded planes, ``publish_tiles`` on every backend,
and ``WorldMap`` ingest, alignment, eviction, relaxation, publication and
state carry — a JAX world's saved state loads into the port and the
reverse.  The world map fed by the loop engine's ``on_install`` tap holds
``fuse_planes_np`` of the installed planes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.mapping import tiles as jtiles
from rplidar_ros2_driver_tpu.mapping import worldmap as jworld
from rplidar_ros2_driver_tpu.ops import loop_close as jlc
from rplidar_ros2_driver_tpu.ops import scan_match as jsm
from rplidar_ros2_driver_tpu.ops import tile_quant as jtq
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.mapping import tiles as ttiles
from rplidar_ros2_driver_tpu_torch.mapping import worldmap as tworld
from rplidar_ros2_driver_tpu_torch.ops import loop_close as tlc
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from rplidar_ros2_driver_tpu_torch.ops import tile_quant as ttq
from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine
from rplidar_ros2_driver_tpu_torch.tools.loop_drift import DriftingFrontEnd, loop_drift_trace
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GRID = 64
Z3 = np.zeros((3,), np.int32)


def world_cfgs(backend: str = "int8", **over):
    """(JAX WorldConfig, port WorldConfig) of one geometry."""
    out = []
    for sm, lc, tl, wm in ((jsm, jlc, jtiles, jworld), (tsm, tlc, ttiles, tworld)):
        mc = sm.MapConfig(grid=GRID, cell_m=0.1, beams=256)
        base = dict(base=mc, match=lc.derive_match_config(mc, theta_window=4, window_cells=2),
                    tile=tl.TileConfig(grid=GRID, tile_cells=8, clamp_q=mc.clamp_q,
                                       backend=backend),
                    max_submaps=4, merge_revs=2, publish_ticks=2)
        base.update(over)
        out.append(wm.WorldConfig(**base))
    return out


def blob_plane(seed: int, n: int = 60) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = np.zeros((GRID, GRID), np.int32)
    idx = rng.integers(14, GRID - 14, size=(n, 2))
    p[idx[:, 0], idx[:, 1]] = 512
    return p


def assert_same_snapshot(got, want):
    for f in ("version", "payload_bytes", "raw_bytes", "schema"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("tile_ids", "values", "runs", "tile_nruns"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    if want.dense is None:
        assert got.dense is None
    else:
        np.testing.assert_array_equal(got.dense, want.dense)
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)


def assert_same_world_state(got: dict, want: dict):
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["acc"], want["acc"])
    assert got["acc"].dtype == np.int32
    assert len(got["members"]) == len(want["members"])
    for a, b in zip(got["members"], want["members"]):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("version", "last_rev", "ticks", "dirty", "merges", "evictions", "serving_version"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# ops/tile_quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_level_coding_matches_jax(bits):
    rng = np.random.default_rng(bits)
    plane = rng.integers(-9000, 9000, (GRID, GRID)).astype(np.int32)
    plane[:20] = 0                                  # long runs
    clamp = 8192
    shift = ttq.min_tile_shift(clamp, bits)
    assert shift == jtq.min_tile_shift(clamp, bits)
    assert ttq.quant_error_bound(shift) == jtq.quant_error_bound(shift)
    lv = ttq.quantize_plane(plane, clamp, shift)
    np.testing.assert_array_equal(lv, jtq.quantize_plane(plane, clamp, shift))
    np.testing.assert_array_equal(ttq.dequantize_plane(lv, shift), jtq.dequantize_plane(lv, shift))
    flat = lv.reshape(-1)
    packed = ttq.pack_nibbles(flat[:777] & 0xF)
    np.testing.assert_array_equal(packed, jtq.pack_nibbles(flat[:777] & 0xF))
    np.testing.assert_array_equal(ttq.unpack_nibbles(packed, 777), jtq.unpack_nibbles(packed, 777))
    long = np.concatenate([np.zeros(ttq.RUN_LEN_MAX * 2 + 5, np.int32), flat])
    for a, b in zip(ttq.rle_encode(long), jtq.rle_encode(long)):
        np.testing.assert_array_equal(a, b)
    values, runs = ttq.rle_encode(long)
    np.testing.assert_array_equal(ttq.rle_decode(values, runs), long)
    assert ttq.rle_payload_bytes(values.size, bits) == jtq.rle_payload_bytes(values.size, bits)
    assert ttq.TILE_QUANT_VERSION == jtq.TILE_QUANT_VERSION


def test_fusion_ops_match_jax_and_wrap():
    """In-place add/sub on the world tensor equal the JAX package's fused
    ops, int32 wrap included, and retract is the exact inverse."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    planes = [rng.integers(-2**31, 2**31 - 1, (GRID, GRID), dtype=np.int64).astype(np.int32)
              for _ in range(4)]
    acc = torch.zeros((GRID, GRID), dtype=torch.int32)
    jacc = jnp.zeros((GRID, GRID), jnp.int32)
    for p in planes:
        assert ttq.fuse_accumulate(acc, torch.from_numpy(p)) is acc
        jacc = jtq.fuse_accumulate(jacc, jnp.asarray(np.array(p)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(acc.numpy(), ttq.fuse_planes_np(planes))
    np.testing.assert_array_equal(ttq.fuse_planes_np(planes), jtq.fuse_planes_np(planes))
    ttq.fuse_retract(acc, torch.from_numpy(planes[1]))
    jacc = jtq.fuse_retract(jacc, jnp.asarray(np.array(planes[1])))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(acc.numpy(), ttq.fuse_planes_np(planes[:1] + planes[2:]))
    with pytest.raises(ValueError):
        ttq.fuse_planes_np([])


# ---------------------------------------------------------------------------
# mapping/tiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["raw", "int8", "int4"])
def test_publish_tiles_matches_jax(backend):
    rng = np.random.default_rng(11)
    plane = np.zeros((GRID, GRID), np.int32)
    plane[8:40, 16:48] = rng.integers(-3000, 12000, (32, 32))
    jc = jtiles.TileConfig(grid=GRID, tile_cells=8, clamp_q=8192, backend=backend)
    tc = ttiles.TileConfig(grid=GRID, tile_cells=8, clamp_q=8192, backend=backend)
    assert (tc.bits, tc.quant_shift, tc.error_bound, tc.tiles_per_side) == (
        jc.bits, jc.quant_shift, jc.error_bound, jc.tiles_per_side)
    got, want = ttiles.publish_tiles(plane, tc, 3), jtiles.publish_tiles(plane, jc, 3)
    assert_same_snapshot(got, want)
    assert got.compression_ratio == want.compression_ratio
    np.testing.assert_array_equal(ttiles.snapshot_grid(got), jtiles.snapshot_grid(want))
    empty = ttiles.publish_tiles(np.zeros((GRID, GRID), np.int32), tc, 1)
    assert empty.tiles == 0 and np.array_equal(ttiles.snapshot_grid(empty), np.zeros((GRID, GRID)))


def test_tile_config_validation_matches_jax():
    assert ttiles.resolve_map_tile_backend("auto") == jtiles.resolve_map_tile_backend("auto")
    for kw in (dict(grid=0, tile_cells=8, clamp_q=1), dict(grid=64, tile_cells=0, clamp_q=1),
               dict(grid=64, tile_cells=7, clamp_q=1), dict(grid=64, tile_cells=8, clamp_q=0),
               dict(grid=64, tile_cells=8, clamp_q=1, backend="int2")):
        with pytest.raises(ValueError) as jerr:
            jtiles.TileConfig(**kw)
        with pytest.raises(ValueError) as terr:
            ttiles.TileConfig(**kw)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        ttiles.resolve_map_tile_backend("int2")


# ---------------------------------------------------------------------------
# mapping/worldmap
# ---------------------------------------------------------------------------


def ingest_both(jw, tw, items):
    for stream, plane, anchor in items:
        j = jw.ingest_submap(stream, plane, anchor)
        assert tw.ingest_submap(stream, plane, anchor) == j
    np.testing.assert_array_equal(tw.world_nodes(), jw.world_nodes())
    assert_same_world_state(tw.save_state(), jw.save_state())


def test_world_map_ingest_align_evict_matches_jax():
    """Shifted copies of a reference (aligned back exactly), unrelated
    blobs, an empty plane (zero weight) and evictions past the cap: the
    accumulation, the members, the relaxed nodes and the counters equal
    the JAX world's at every step."""
    jc, tc = world_cfgs(max_submaps=4)
    jw, tw = jworld.WorldMap(jc), tworld.WorldMap(tc, device="cpu")
    tw.precompile()
    ref = blob_plane(0)
    items = [(0, ref, Z3),
             (1, tworld.shift_plane_np(ref, 3, -2), np.asarray([96, -64, 0], np.int32)),
             (2, blob_plane(5), Z3), (3, np.zeros((GRID, GRID), np.int32), Z3),
             (1, tworld.shift_plane_np(ref, -5, 7), Z3), (2, blob_plane(9), Z3)]
    for item in items:
        ingest_both(jw, tw, [item])
    assert tw.evictions == jw.evictions == 2 and tw.merges == 6
    assert tw.status() == jw.status()
    state = tw.save_state()
    np.testing.assert_array_equal(state["acc"],
                                  ttq.fuse_planes_np([m["plane"] for m in state["members"]]))
    assert tw.evict_oldest() == jw.evict_oldest()
    assert_same_world_state(tw.save_state(), jw.save_state())


def test_world_map_serving_matches_jax():
    jc, tc = world_cfgs(backend="int4", publish_ticks=3)
    jw, tw = jworld.WorldMap(jc), tworld.WorldMap(tc, device="cpu")
    ticks = []
    for k in range(7):
        if k in (1, 4):
            ingest_both(jw, tw, [(k, blob_plane(k), Z3)])
        due = tw.tick()
        assert due == jw.tick()
        ticks.append(due)
        if due:
            assert_same_snapshot(tw.publish(), jw.publish())
    assert any(ticks) and tw.serving_version == jw.serving_version
    assert tw.overlap_hook() is None and jw.overlap_hook() is None
    assert_same_snapshot(tw.snapshot(), jw.snapshot())
    assert tw.status() == jw.status() and tw.resident_bytes == jw.resident_bytes
    assert tw.merge_due(0, 2) == jw.merge_due(0, 2)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_world_state_carries_across_packages(direction):
    jc, tc = world_cfgs(max_submaps=3)
    jw, tw = jworld.WorldMap(jc), tworld.WorldMap(tc, device="cpu")
    items = [(s, blob_plane(s), Z3) for s in range(4)]
    src, dst = (jw, tw) if direction == "jax_to_port" else (tw, jw)
    for item in items:
        src.ingest_submap(*item)
    src.note_merged(1, 4)
    dst.load_state(src.save_state())
    assert_same_world_state(dst.save_state(), src.save_state())
    np.testing.assert_array_equal(dst.world_nodes(), src.world_nodes())
    # and both continue alike
    for w in (jw, tw):
        if w is src:
            continue
        w.ingest_submap(5, blob_plane(5), Z3)
    src.ingest_submap(5, blob_plane(5), Z3)
    assert_same_world_state(tw.save_state(), jw.save_state())


def test_world_load_rejects_version_and_geometry():
    _, tc = world_cfgs()
    tw = tworld.WorldMap(tc, device="cpu")
    tw.ingest_submap(0, blob_plane(0), Z3)
    bad = dict(tw.save_state(), version=99)
    with pytest.raises(ValueError, match="version"):
        tw.load_state(bad)
    small = dict(tw.save_state(), acc=np.zeros((32, 32), np.int32))
    with pytest.raises(ValueError, match="geometry"):
        tw.load_state(small)
    with pytest.raises(RuntimeError):
        tworld.WorldMap(tc, device="cpu").align_submap(blob_plane(0))


def test_world_map_defaults_to_the_card(monkeypatch):
    _, tc = world_cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tworld.WorldMap(tc)


def test_world_config_from_params_matches_jax():
    kw = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), map_enable=True,
              map_grid=GRID, map_cell_m=0.1, world_map_enable=True, world_tile_cells=8,
              world_max_submaps=5, world_merge_revs=3, world_publish_ticks=4)
    jp, tp = JParams(**kw), DriverParams(**kw)
    from rplidar_ros2_driver_tpu.mapping import mapper as jmapper

    jc = jworld.world_config_from_params(jp, jmapper.map_config_from_params(jp, 256))
    tc = tworld.world_config_from_params(tp, tmapper.map_config_from_params(tp, 256))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.graph) == dataclasses.asdict(jc.graph)


def test_world_map_on_the_loop_engines_install_tap():
    """The engine's on_install tap feeds the world the exact planes the
    library stored: the accumulation is their aligned sum, and one
    publication equals publish_tiles of the host sum."""
    p = DriverParams(filter_backend="cpu", filter_chain=("clip", "median", "voxel"),
                     map_enable=True, map_backend="host", map_grid=GRID, map_cell_m=0.1,
                     loop_enable=True, loop_backend="fused", loop_submap_revs=4,
                     loop_check_revs=2, loop_max_submaps=8, loop_weight=8,
                     pose_graph_max_constraints=32, world_map_enable=True, world_tile_cells=8,
                     world_max_submaps=16)
    fe = DriftingFrontEnd(p, 2, 256, 4)
    eng = LoopClosureEngine(p, fe)
    world = tworld.WorldMap(tworld.world_config_from_params(p, fe.cfg), device="cpu")
    installed = []

    def tap(i, plane, anchor):
        installed.append(np.asarray(plane).copy())
        world.ingest_submap(i, plane, anchor)

    eng.on_install = tap
    trace, masks, _ = loop_drift_trace(2, 256, 16, 8, 0.1)
    for pts, drifted in trace:
        eng.observe(fe.submit(pts, masks, drifted))
    assert len(installed) == eng.installs == 8 and world.merges == 8
    state = world.save_state()
    aligned = [m["plane"] for m in state["members"]]
    np.testing.assert_array_equal(state["acc"], ttq.fuse_planes_np(aligned))
    # the members' planes are whole-cell shifts of the installed ones
    assert all(int(m["plane"].sum()) <= int(p_in.sum())
               for m, p_in in zip(state["members"], installed))
    snap = world.publish()
    assert_same_snapshot(snap, ttiles.publish_tiles(ttq.fuse_planes_np(aligned), world.cfg.tile, 1))
