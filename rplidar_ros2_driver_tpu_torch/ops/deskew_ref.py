"""NumPy golden reference for the de-skew + sweep-reconstruction stage
(ops/deskew.py) and the host-golden stream twin the parity suite drives —
a copy of the JAX package's ``ops/deskew_ref.py`` on this package's
DeskewConfig, decoder and assembler.

The datapath is integer end to end (see the exactness notes in
ops/deskew.py), so every function here is BIT-EXACT against the fused
single-stream, fleet and super-step lowerings of ops/ingest.py — not
"close", equal (tests/test_torch_deskew.py, tests/test_torch_fused_ingest.py).

Keep every function in literal lockstep with its ops/deskew.py twin; a
divergence is a bug in whichever side moved.

:class:`HostDeskewStream` is the per-stream state machine mirroring how
ops/ingest._segment_filter_core sequences the two stages per dispatch:
first the tick's freshly appended nodes are de-skewed with the CARRIED
motion estimate and rasterized into the sub-sweep ring (recon emits
every tick), then each revolution completed this tick re-estimates the
motion from consecutive profiles and de-skews its own nodes before they
enter the filter.  :class:`DeskewHostTwin` wraps the host golden decode
path (BatchScanDecoder + ScanAssembler) with a push_nodes tap so the
twin sees exactly the valid node stream the fused batch sees.
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.deskew import (
    RECON_EMPTY,
    DeskewConfig,
    node_trig_table,
    profile_trig,
    shift_candidates,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match import ANG_BITS


def wire_clamp_np(angle, dist, quality, flag):
    """The wire clamps (ops/ingest._wire_clamp / the host pack's
    _pack_compact_rows domain) as int32 numpy — what both backends'
    node streams look like when they reach the de-skew stage."""
    angle = np.asarray(angle, np.int64) & 0xFFFF
    dist = np.asarray(dist, np.int64)
    dist = np.where(dist < 0, 0x3FFFF, np.minimum(dist, 0x3FFFF))
    quality = np.asarray(quality, np.int64) & 0xFF
    flag = np.asarray(flag, np.int64) & 0x3F
    return (
        angle.astype(np.int32), dist.astype(np.int32),
        quality.astype(np.int32), flag.astype(np.int32),
    )


def beam_of_np(angle, beams: int):
    return np.clip(
        (angle.astype(np.int64) * beams) // 65536, 0, beams - 1
    ).astype(np.int32)


def profile_from_nodes_np(angle, dist, valid, cfg: DeskewConfig):
    d = cfg.profile_beams
    b = beam_of_np(np.asarray(angle, np.int32), d)
    live = np.asarray(valid, bool) & (np.asarray(dist, np.int32) > 0)
    prof = np.full((d,), RECON_EMPTY, np.int32)
    # min is order-independent over int32: the scatter form here equals
    # the fused path's tiled masked-min exactly
    np.minimum.at(prof, b[live], np.asarray(dist, np.int32)[live])
    return prof


def estimate_motion_np(prev_prof, cur_prof, cfg: DeskewConfig):
    d = cfg.profile_beams
    mt = cfg.max_trans_q2
    cands = shift_candidates(cfg)
    vp = prev_prof != RECON_EMPTY
    vc = cur_prof != RECON_EMPTY

    scores = np.empty((len(cands),), np.int32)
    for i, s in enumerate(cands):
        aligned = np.roll(cur_prof, int(s))
        both = vp & np.roll(vc, int(s))
        diff = np.clip(np.where(both, aligned - prev_prof, 0), -mt, mt)
        cnt = int(both.sum())
        sad = int(np.abs(diff).sum())
        scores[i] = (
            sad // max(cnt, 1) if cnt >= cfg.min_valid else RECON_EMPTY
        )
    k = int(np.argmin(scores))  # first-min-wins: ties prefer s=0
    s_best = int(cands[k])
    if scores[k] == RECON_EMPTY:
        return np.zeros((3,), np.int32)

    aligned = np.roll(cur_prof, s_best)
    both = vp & np.roll(vc, s_best)
    diff = np.clip(np.where(both, aligned - prev_prof, 0), -mt, mt)
    trig = profile_trig(cfg)
    c7 = trig[:, 0] >> 7
    s7 = trig[:, 1] >> 7
    bi = both.astype(np.int32)
    num_x = int(np.sum(diff * c7 * bi))
    den_x = int(np.sum(c7 * c7 * bi))
    num_y = int(np.sum(diff * s7 * bi))
    den_y = int(np.sum(s7 * s7 * bi))
    dx = int(np.clip(-(num_x // max(den_x >> 7, 1)), -mt, mt))
    dy = int(np.clip(-(num_y // max(den_y >> 7, 1)), -mt, mt))
    dth = int(np.clip(s_best * (65536 // d), -(1 << 13), 1 << 13))
    return np.asarray([dx, dy, dth], np.int32)


def apply_deskew_np(angle, dist, valid, motion, cfg: DeskewConfig):
    del cfg  # geometry-independent, kept for twin-signature lockstep
    angle = np.asarray(angle, np.int32)
    dist = np.asarray(dist, np.int32)
    table = node_trig_table()
    rem = 65536 - angle
    dang = (rem * int(motion[2])) >> 16
    angle2 = (angle - dang) & 0xFFFF
    idx = angle >> 6
    c = table[idx, 0]
    s = table[idx, 1]
    half = 1 << (ANG_BITS - 1)
    radial = (int(motion[0]) * c + int(motion[1]) * s + half) >> ANG_BITS
    corr = (radial * rem) >> 16
    dist2 = np.clip(dist - corr, 1, 0x3FFFF)
    live = np.asarray(valid, bool) & (dist > 0)
    return (
        np.where(live, angle2, angle).astype(np.int32),
        np.where(live, dist2, dist).astype(np.int32),
    )


def rasterize_subsweep_np(angle, dist, quality, valid, cfg: DeskewConfig):
    b = cfg.recon_beams
    angle = np.asarray(angle, np.int32)
    dist = np.asarray(dist, np.int32)
    quality = np.asarray(quality, np.int32)
    ok = np.asarray(valid, bool) & (dist > 0)
    if cfg.enable_clip:
        # graftlint: policed — literal twin of the fused rasterizer's
        # one sanctioned float op: a single f32 multiply + compares
        # gating the integer drop mask (deterministic elementwise)
        dist_m = dist.astype(np.float32) * np.float32(1.0 / 4000.0)
        ok = (
            ok
            & (dist_m >= np.float32(cfg.range_min_m))
            & (dist_m <= np.float32(cfg.range_max_m))
            & (quality.astype(np.float32) >= np.float32(cfg.intensity_min))
        )
    beam = beam_of_np(angle, b)
    packed = (dist << 8) | np.clip(quality, 0, 255)
    seg = np.full((b,), RECON_EMPTY, np.int32)
    np.minimum.at(seg, beam[ok], packed[ok].astype(np.int32))
    return seg


def combine_ring_np(ring, pos):
    k = ring.shape[0]
    aged = np.roll(ring, -(int(pos) % k), axis=0)
    combined = np.full(ring.shape[1:], RECON_EMPTY, np.int32)
    for i in range(k):
        combined = np.where(aged[i] != RECON_EMPTY, aged[i], combined)
    return combined


class HostDeskewStream:
    """Per-stream host-golden twin of the fused core's de-skew +
    reconstruction state (the numpy analog of the four optional
    IngestState planes).  Drive it with the SAME per-dispatch node
    stream the fused path sees — :meth:`tick` first with everything the
    dispatch appended, then :meth:`revolution` for each revolution the
    dispatch completed, in order — and every returned plane is
    bit-exact against the fused lowerings."""

    def __init__(self, cfg: DeskewConfig) -> None:
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        """The decode-carry reset (scan-mode switch, quarantine rejoin):
        the ring, profile and motion estimate restart with the engines
        — ops/ingest._reset_stream_decode's exact semantics."""
        cfg = self.cfg
        self.ring = np.full(
            (cfg.recon_window, cfg.recon_beams), RECON_EMPTY, np.int32
        )
        self.pos = 0
        self.prof = np.full((cfg.profile_beams,), RECON_EMPTY, np.int32)
        self.motion = np.zeros((3,), np.int32)

    def tick(self, angle, dist, quality, flag=None):
        """One dispatch's appended valid nodes (possibly none): de-skew
        with the CARRIED motion estimate, rasterize the sub-sweep, push
        it into the ring, and return ``(combined, pushed)`` — the
        reconstructed sweep emitted this tick and whether a segment was
        pushed (an empty tick re-emits the previous reconstruction)."""
        del flag
        angle = np.asarray(angle, np.int32)
        dist = np.asarray(dist, np.int32)
        quality = np.asarray(quality, np.int32)
        pushed = angle.size > 0
        if pushed:
            valid = np.ones(angle.shape, bool)
            a2, d2 = apply_deskew_np(
                angle, dist, valid, self.motion, self.cfg
            )
            seg = rasterize_subsweep_np(a2, d2, quality, valid, self.cfg)
            self.ring[self.pos % self.cfg.recon_window] = seg
            self.pos += 1
        return combine_ring_np(self.ring, self.pos), pushed

    def revolution(self, angle, dist, quality=None, flag=None):
        """One completed revolution's (wire-clamped) nodes: re-estimate
        the motion from the consecutive profiles, carry this
        revolution's raw profile for the next, and return the de-skewed
        ``(angle', dist')`` — what the filter consumes on both
        backends."""
        del quality, flag
        angle = np.asarray(angle, np.int32)
        dist = np.asarray(dist, np.int32)
        valid = np.ones(angle.shape, bool)
        prof = profile_from_nodes_np(angle, dist, valid, self.cfg)
        self.motion = estimate_motion_np(self.prof, prof, self.cfg)
        self.prof = prof
        return apply_deskew_np(angle, dist, valid, self.motion, self.cfg)


class DeskewHostTwin:
    """The host golden decode path (BatchScanDecoder + ScanAssembler)
    with the de-skew twin spliced in: feed it the same per-tick frame
    batches the fused engine gets and it yields, per tick, the
    reconstructed sweep plane and the de-skewed completed revolutions
    (ready for a golden ScanFilterChain).  The decoder's push_nodes
    stream IS the fused batch's compacted valid node stream (pinned by
    the existing ingest parity suites), so no second decode exists to
    drift."""

    def __init__(self, cfg: DeskewConfig, max_nodes=None) -> None:
        from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES
        from rplidar_ros2_driver_tpu_torch.driver.assembly import ScanAssembler
        from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder

        self.cfg = cfg
        self.stream = HostDeskewStream(cfg)
        self._tick_nodes: list = []
        self._completed: list = []
        twin = self

        class _TapAssembler(ScanAssembler):
            def push_nodes(self, angle_q14, dist_q2, quality, flag, ts=None):
                if len(angle_q14):
                    twin._tick_nodes.append(
                        wire_clamp_np(angle_q14, dist_q2, quality, flag)
                    )
                return super().push_nodes(
                    angle_q14, dist_q2, quality, flag, ts
                )

        self.assembler = _TapAssembler(
            max_nodes=max_nodes or MAX_SCAN_NODES,
            on_complete=lambda s: self._completed.append(dict(s)),
        )
        self.decoder = BatchScanDecoder(self.assembler)

    def reset(self) -> None:
        """Scan-mode switch: decoder + assembler + de-skew carries reset
        (the host path's _begin_streaming semantics; the filter window
        is the caller's to carry)."""
        self.decoder.reset()
        self.assembler.reset()
        self.stream.reset()
        self._tick_nodes.clear()
        self._completed.clear()

    def tick(self, ans_type: int, items: list):
        """One fused-dispatch-equivalent frame batch.  Returns
        ``(combined, pushed, revolutions)``: the reconstructed sweep
        plane, whether this tick pushed a segment, and a list of
        ``(angle', dist', scan_dict)`` de-skewed completed revolutions
        in completion order."""
        self._tick_nodes.clear()
        self._completed.clear()
        self.decoder.on_measurement_batch(int(ans_type), list(items))
        if self._tick_nodes:
            parts = list(zip(*self._tick_nodes))
            a, d, q = (np.concatenate(p) for p in parts[:3])
        else:
            a = d = q = np.zeros((0,), np.int32)
        combined, pushed = self.stream.tick(a, d, q)
        revs = []
        for scan in self._completed:
            ca, cd, cq, cf = wire_clamp_np(
                scan["angle_q14"], scan["dist_q2"],
                scan["quality"], scan["flag"],
            )
            a2, d2 = self.stream.revolution(ca, cd)
            revs.append((a2, d2, {**scan, "quality": cq, "flag": cf}))
        return combined, pushed, revs
