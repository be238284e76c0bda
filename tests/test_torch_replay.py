"""The capture replay path of the PyTorch package against the JAX package.

Recorder format (byte-identical files), batched decode of a multi-format
capture, and ``replay_through_chain`` — the fused K-scan chain with the
``pallas`` (kernel B3's plain version on the CPU; the JAX package's Pallas
kernel in interpret mode), ``xla`` and ``inc`` medians — bit for bit on
the CPU: ranges and every final-state field.  Then the fused path against
K streaming steps of the package itself, and the ``replay`` CLI.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu import replay as jreplay
from rplidar_ros2_driver_tpu.core.config import DriverParams as JaxParams
from rplidar_ros2_driver_tpu.ops import filters as jf
from rplidar_ros2_driver_tpu_torch import replay as treplay
from rplidar_ros2_driver_tpu_torch.__main__ import main
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.ops import filters as tf
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.ops import wire
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STATE_FIELDS = ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled")


def dense_frames(seed: int, revs: int, ppr: int = 400) -> list[bytes]:
    """Seeded DenseBoost-shaped dense capsules (40 samples a frame): a
    2 m +/- 0.5 m ring with noise and drop-outs over ``revs`` turns."""
    rng = np.random.default_rng(seed)
    frames = []
    for n, idx in enumerate(range(0, revs * ppr, 40)):
        pts = (np.arange(40) + idx) % ppr
        mm = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr) + rng.normal(0.0, 10.0, 40)
        mm[rng.random(40) < 0.05] = 0
        start_q6 = int(360.0 * (idx % ppr) / ppr * 64) & 0x7FFF
        frames.append(wire.encode_dense_capsule(start_q6, n == 0, mm.astype(int)))
    return frames


def write_capture(path, frames, ans=int(Ans.MEASUREMENT_DENSE_CAPSULED)):
    with treplay.FrameRecorder(str(path)) as rec:
        for i, fr in enumerate(frames):
            rec.write(ans, fr, 0.001 * i)
    return str(path)


def mixed_frames(rng):
    """(ans_type, payload) runs of all six formats, with a corrupt frame,
    a malformed-length record and a non-measurement record."""
    out = []
    for i in range(12):
        out.append((0x81, wire.encode_normal_node(int(rng.integers(0, 360 << 6)),
                                                  int(rng.integers(0, 1 << 16)),
                                                  int(rng.integers(0, 64)), i % 5 == 0)))
    starts = (np.cumsum(rng.integers(300, 900, 10)) % (360 << 6)).astype(int)
    for i, s in enumerate(starts):
        dist = rng.integers(0, 1 << 14, (16, 2)) << 2
        fr = bytearray(wire.encode_capsule(int(s), i == 0, dist, rng.integers(0, 64, (16, 2))))
        if i == 4:
            fr[10] ^= 0xFF  # corrupt checksum
        out.append((0x82, bytes(fr)))
    for i, s in enumerate(starts):
        out.append((0x84, wire.encode_ultra_capsule(
            int(s), i == 0, rng.integers(0, 4096, 32), rng.integers(-512, 512, 32),
            rng.integers(-512, 512, 32))))
    out.append((0x85, b"\x00" * 10))  # malformed length: skipped
    out.append((0x04, b"\x01" * 20))  # not a measurement: skipped
    for i, s in enumerate(starts):
        out.append((0x85, wire.encode_dense_capsule(int(s), i == 0, rng.integers(0, 1 << 15, 40))))
    for i, s in enumerate(starts):
        words = [wire.ultra_dense_encode_sample(int(d), int(q))
                 for d, q in zip(rng.integers(100, 30000, 64), rng.integers(0, 256, 64))]
        out.append((0x86, wire.encode_ultra_dense_capsule(int(s), i == 0, np.array(words))))
    for i in range(3):
        out.append((0x83, wire.encode_hq_capsule(
            rng.integers(0, 1 << 16, 96), rng.integers(0, 1 << 32, 96),
            rng.integers(0, 256, 96), np.where(np.arange(96) == 0, 1, 2))))
    return out


# ---------------------------------------------------------------------------
# recorder format
# ---------------------------------------------------------------------------


def test_recorder_round_trip(tmp_path):
    p = str(tmp_path / "cap.rplr")
    with treplay.FrameRecorder(p) as rec:
        rec.write(0x81, b"\x01\x02\x03\x04\x05", 1.5)
        rec.write(0x82, b"\xff" * 84, 2.0)
        assert rec.frames == 2
    assert list(treplay.read_frames(p)) == [
        (0x81, 1.5, b"\x01\x02\x03\x04\x05"), (0x82, 2.0, b"\xff" * 84)
    ]
    assert list(jreplay.read_frames(p)) == list(treplay.read_frames(p))


def test_torn_tail_and_bad_magic(tmp_path):
    p = str(tmp_path / "cap.rplr")
    with treplay.FrameRecorder(p) as rec:
        rec.write(0x81, b"\x01" * 5, 1.0)
        rec.write(0x85, b"\x02" * 84, 2.0)
    raw = open(p, "rb").read()
    for n in range(len(raw)):
        cut = tmp_path / f"cut{n}.rplr"
        cut.write_bytes(raw[:n])
        assert list(treplay.read_frames(str(cut))) == list(jreplay.read_frames(str(cut))), n
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError):
        list(treplay.read_frames(str(junk)))


def test_recorders_write_identical_bytes(tmp_path):
    rng = np.random.default_rng(5)
    frames = mixed_frames(rng)
    paths = []
    for name, recorder in (("port", treplay.FrameRecorder), ("jax", jreplay.FrameRecorder)):
        p = str(tmp_path / f"{name}.rplr")
        with recorder(p) as rec:
            for i, (ans, fr) in enumerate(frames):
                rec.write(ans, fr, 0.25 * i)
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_closed_recorder_drops_writes(tmp_path):
    p = str(tmp_path / "cap.rplr")
    rec = treplay.FrameRecorder(p)
    rec.close()
    rec.write(0x81, b"\x01" * 5)
    rec.close()
    assert rec.frames == 0 and list(treplay.read_frames(p)) == []


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _assert_same_decode(ours, theirs):
    assert ours.runs == theirs.runs
    for key in ("angle_q14", "dist_q2", "quality", "flag"):
        got, want = getattr(ours, key), getattr(theirs, key)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert ours.num_nodes == theirs.num_nodes


def test_decode_multi_format_capture_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    p = str(tmp_path / "mixed.rplr")
    with treplay.FrameRecorder(p) as rec:
        for ans, fr in mixed_frames(rng):
            rec.write(ans, fr)
    ours = treplay.decode_recording(p, device="cpu")
    _assert_same_decode(ours, jreplay.decode_recording(p))
    assert [r[0] for r in ours.runs] == [0x81, 0x82, 0x84, 0x85, 0x86, 0x83]


def test_decode_dense_capture_and_revolutions_match_jax(tmp_path):
    p = write_capture(tmp_path / "dense.rplr", dense_frames(3, 6))
    ours = treplay.decode_recording(p, device="cpu")
    theirs = jreplay.decode_recording(p)
    _assert_same_decode(ours, theirs)
    revs, jrevs = ours.revolutions(), theirs.revolutions()
    assert len(revs) == len(jrevs) == 5
    for a, b in zip(revs, jrevs):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
        assert 390 <= len(a["angle_q14"]) <= 410


def test_decode_without_a_card_raises(tmp_path, monkeypatch):
    """The default device is the card: without one the decode raises,
    never falls back to the host."""
    p = write_capture(tmp_path / "dense.rplr", dense_frames(3, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        treplay.decode_recording(p)


def test_empty_capture_decodes_to_nothing(tmp_path):
    p = write_capture(tmp_path / "empty.rplr", [])
    dec = treplay.decode_recording(p, device="cpu")
    assert dec.num_nodes == 0 and dec.runs == [] and dec.revolutions() == []


# ---------------------------------------------------------------------------
# replay_through_chain against the JAX package
# ---------------------------------------------------------------------------

GEOM = dict(filter_window=8, voxel_grid_size=32, voxel_cell_m=0.25)
BEAMS = 256
CAPACITY = 512


@pytest.fixture(scope="module")
def dense_revs(tmp_path_factory):
    p = write_capture(tmp_path_factory.mktemp("cap") / "dense.rplr", dense_frames(7, 24))
    revs = treplay.decode_recording(p, device="cpu").revolutions()
    assert len(revs) == 23
    return revs


def _params(median: str, chain=("clip", "median", "voxel"), **over):
    kw = dict(GEOM, filter_chain=chain, median_backend=median, **over)
    return DriverParams(filter_backend="cpu", **kw), JaxParams(filter_backend="cpu", **kw)


def assert_same_state(ours, theirs, with_sorted: bool):
    for f in STATE_FIELDS:
        got = getattr(ours, f).numpy()
        want = np.asarray(getattr(theirs, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    if with_sorted:
        np.testing.assert_array_equal(ours.median_sorted.numpy(), np.asarray(theirs.median_sorted))
    else:
        assert ours.median_sorted is None


@pytest.mark.parametrize("median", ["pallas", "xla", "inc"])
@pytest.mark.parametrize("chunk", [3, 8, 10, 30])  # K < W, K = W, ragged tail, K > W
def test_replay_through_chain_matches_jax(dense_revs, median, chunk):
    ours_p, jax_p = _params(median)
    ranges, state = treplay.replay_through_chain(
        dense_revs, ours_p, beams=BEAMS, capacity=CAPACITY, chunk=chunk
    )
    jranges, jstate = jreplay.replay_through_chain(
        dense_revs, jax_p, beams=BEAMS, capacity=CAPACITY, chunk=chunk
    )
    assert ranges.shape == (len(dense_revs), BEAMS) and ranges.dtype == np.float32
    np.testing.assert_array_equal(ranges, np.asarray(jranges))
    assert_same_state(state, jstate, with_sorted=median == "inc")
    assert np.isfinite(ranges).mean() > 0.8
    assert int(state.voxel_acc.sum()) > 0


@pytest.mark.parametrize(
    "chain,over",
    [
        (("clip", "voxel"), {}),                      # no median: raw gridded rows
        (("clip", "median"), {}),                     # no voxel: hit state untouched
        (("median", "voxel"), {}),                    # no clip
        (("clip", "median", "voxel"), {"voxel_backend": "matmul"}),
    ],
)
def test_replay_stage_switches_match_jax(dense_revs, chain, over):
    ours_p, jax_p = _params("xla", chain=chain, **over)
    ranges, state = treplay.replay_through_chain(
        dense_revs, ours_p, beams=BEAMS, capacity=CAPACITY, chunk=10
    )
    jranges, jstate = jreplay.replay_through_chain(
        dense_revs, jax_p, beams=BEAMS, capacity=CAPACITY, chunk=10
    )
    np.testing.assert_array_equal(ranges, np.asarray(jranges))
    assert_same_state(state, jstate, with_sorted=False)


def test_replay_of_no_revolutions(dense_revs):
    ours_p, _ = _params("pallas")
    ranges, state = treplay.replay_through_chain([], ours_p, beams=BEAMS)
    assert ranges.shape == (0, BEAMS)
    assert int(state.filled) == 0


def test_replay_without_a_card_raises(dense_revs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        treplay.replay_through_chain(dense_revs, DriverParams(), beams=BEAMS)


# ---------------------------------------------------------------------------
# compact_filter_scan: against the JAX package's, and against K streaming steps
# ---------------------------------------------------------------------------


def _cfg(median: str, **over) -> tf.FilterConfig:
    return tf.FilterConfig(window=8, beams=BEAMS, grid=32, cell_m=0.25, median_backend=median,
                           **over)


def _seq(revs, capacity=CAPACITY):
    seq, counts = tf.pack_host_scans_compact(revs, capacity)
    return torch.from_numpy(seq.view(np.int16)), torch.from_numpy(counts), seq, counts


def _warm_state(cfg, revs):
    """A state a few steps into the ring (cursor off 0, window part-filled)."""
    state = tf.FilterState.for_config(cfg, device="cpu")
    for r in revs:
        buf = tf.pack_host_scan_counted(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"],
                                        CAPACITY)
        tf.counted_filter_step_wire(state, torch.from_numpy(buf.view(np.int16)), cfg)
    return state


@pytest.mark.parametrize("median", ["pallas", "xla", "inc_xla"])
@pytest.mark.parametrize("warm,k", [(0, 5), (5, 3), (5, 12), (3, 8)])
def test_fused_equals_streaming_steps(dense_revs, median, warm, k):
    cfg = _cfg(median)
    start = _warm_state(cfg, dense_revs[:warm])
    seq_t, counts_t, _, _ = _seq(dense_revs[warm : warm + k])

    fused, med = tf.compact_filter_scan(start.clone(), seq_t, counts_t, cfg)
    seq_state, seq_med = tf._compact_filter_scan_sequential(start.clone(), seq_t, counts_t, cfg)
    assert med.shape == (k, BEAMS)
    assert torch.equal(med, seq_med)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(fused, f), getattr(seq_state, f)), f
    if median == "inc_xla":
        assert torch.equal(fused.median_sorted, seq_state.median_sorted)
        assert torch.equal(fused.median_sorted, torch.sort(fused.range_window, dim=0).values)

    # the production wire step, one revolution at a time, lands on the same state
    wire_state = start.clone()
    for r in dense_revs[warm : warm + k]:
        buf = tf.pack_host_scan_counted(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"],
                                        CAPACITY)
        tf.counted_filter_step_wire(wire_state, torch.from_numpy(buf.view(np.int16)), cfg)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(fused, f), getattr(wire_state, f)), f


@pytest.mark.parametrize("median", ["pallas", "xla"])
def test_compact_filter_scan_matches_jax_from_a_warm_state(dense_revs, median):
    cfg = _cfg(median)
    jcfg = jf.FilterConfig(**dataclasses.asdict(cfg))
    start = _warm_state(cfg, dense_revs[:5])
    # copies: on the CPU to_numpy() shares memory with the state updated below
    jstate = jf.FilterState(**{k: jnp.array(v, copy=True) for k, v in start.to_numpy().items()})
    seq_t, counts_t, seq, counts = _seq(dense_revs[5:16])
    state, med = tf.compact_filter_scan(start, seq_t, counts_t, cfg)
    jstate, jmed = jf.compact_filter_scan(jstate, jnp.asarray(seq), jnp.asarray(counts), jcfg)
    np.testing.assert_array_equal(med.numpy(), np.asarray(jmed))
    assert_same_state(state, jstate, with_sorted=False)


def test_fused_updates_the_state_in_place(dense_revs):
    cfg = _cfg("pallas")
    state = tf.FilterState.for_config(cfg, device="cpu")
    held = {f: getattr(state, f) for f in STATE_FIELDS}
    seq_t, counts_t, _, _ = _seq(dense_revs[:4])
    out, _ = tf.compact_filter_scan(state, seq_t, counts_t, cfg)
    assert out is state
    for f in STATE_FIELDS:
        assert getattr(state, f) is held[f], f
    assert int(state.cursor) == 4 and int(state.filled) == 4


def test_fused_pallas_median_goes_through_the_b3_wrapper(dense_revs, monkeypatch):
    calls = []
    real = mk.sliding_median_kernel

    def spy(ext, window):
        calls.append((tuple(ext.shape), window))
        return real(ext, window)

    monkeypatch.setattr(mk, "sliding_median_kernel", spy)
    seq_t, counts_t, _, _ = _seq(dense_revs[:6])
    tf.compact_filter_scan(tf.FilterState.for_config(_cfg("pallas"), device="cpu"),
                           seq_t, counts_t, _cfg("pallas"))
    tf.compact_filter_scan(tf.FilterState.for_config(_cfg("xla"), device="cpu"),
                           seq_t, counts_t, _cfg("xla"))
    assert calls == [((8 + 6, BEAMS), 8)]


def test_pack_host_scans_compact_matches_jax(dense_revs):
    seq, counts = tf.pack_host_scans_compact(dense_revs[:4], CAPACITY)
    jseq, jcounts = jf.pack_host_scans_compact(dense_revs[:4], CAPACITY)
    np.testing.assert_array_equal(seq, jseq)
    np.testing.assert_array_equal(counts, jcounts)
    assert seq.dtype == np.uint16 and counts.dtype == np.int32
    r = dense_revs[0]
    buf, count = tf.pack_host_scan_compact(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"],
                                           CAPACITY)
    jbuf, jcount = jf.pack_host_scan_compact(r["angle_q14"], r["dist_q2"], r["quality"],
                                             r["flag"], CAPACITY)
    np.testing.assert_array_equal(buf, jbuf)
    assert count == jcount
    with pytest.raises(ValueError, match="capacity"):
        tf.pack_host_scans_compact(dense_revs[:1], 16)


# ---------------------------------------------------------------------------
# the replay CLI
# ---------------------------------------------------------------------------


def test_cli_replay_chain_on_the_cpu(tmp_path, capsys):
    p = write_capture(tmp_path / "dense.rplr", dense_frames(9, 5, ppr=3200))
    assert main(["replay", p, "--chain", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert f"{p}: " in out and "4 complete revolutions" in out
    assert "run: MEASUREMENT_DENSE_CAPSULED" in out
    assert "points/rev: min=" in out
    assert "chain: 4 scans through the fused multi-scan step" in out
    median_m = float(out.split("median range ")[1].split(" m")[0])
    assert abs(median_m - 2.0) < 0.1 and "voxel occupancy" in out


def test_cli_replay_decode_only_and_empty(tmp_path, capsys):
    p = write_capture(tmp_path / "short.rplr", dense_frames(9, 1, ppr=400)[:3])
    assert main(["replay", p, "--chain", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 complete revolutions" in out and "--chain skipped" in out


def test_cli_replay_refuses_unported_and_cardless_runs(tmp_path, monkeypatch):
    p = write_capture(tmp_path / "dense.rplr", dense_frames(9, 2))
    assert main(["replay", p, p, "--chain", "--cpu"]) == 0  # the fleet replay (A.7a)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["replay", p])
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["replay", p, "--fused"])  # the fused replay runs on the card too
