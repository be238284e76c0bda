"""Fused device ingest: raw frame bytes -> filter output on the device.

The PyTorch counterpart of the JAX package's ``ops/ingest.py``, held to it
bit for bit (tests/test_torch_fused_ingest.py): one step per frame batch
runs, on the device of its state,

  1. **unpack** — the batch decoders of ops/unpack.py, with the prev-frame /
     sync-edge / smoothing carries threaded as device values;
  2. **validity compaction + revolution segmentation** — the flag-bit0
     sync split of driver/assembly.ScanAssembler.push_nodes, without
     element-wise loops: a stable argsort compacts the valid nodes, one
     scatter appends them to the carried partial revolution, a
     ``searchsorted`` over the sync-bit cumsum finds each revolution's
     start and ``cummax`` each node's segment (data before the first sync
     dropped, ``max_nodes`` head-keep cap, completed revolutions beyond
     ``max_revs`` per step dropped oldest-first into ``revs_dropped``);
  3. **de-skew + sweep reconstruction** (``cfg.deskew``, ops/deskew.py);
  4. **the filter step** — ops/filters._filter_step_impl once per
     completed revolution;
  5. **the SLAM front-end** (``cfg.mapping``) — each tick's reconstructed
     sweep matched against the stream's log-odds map and absorbed into it
     (ops/scan_match.fleet_map_match_step, once per tick for the whole
     fleet: one launch of each matcher kernel B6/B7/B8).  The MapState
     rides the ingest state (``map_*`` planes, updated in place).

Every function is written over a leading stream axis: the JAX package
``vmap``s a one-stream step, the port puts the streams on a batch axis, so
each kernel launch of a tick serves every stream (the single-stream step
is the one-stream case of the same core).

Where the JAX program branches on device values, the port reads the host:

  * ``lax.switch`` over per-stream formats: the host staged each stream's
    bytes, so it knows each stream's format and frame count per tick; it
    decodes each live stream with its format's decoder and leaves idle
    lanes (no frames) untouched — no device branch, no host read.
  * ``fori_loop`` over the revolution slots: the completed-revolution
    counts come to the host once per step (ONE synchronisation) and the
    filter runs exactly that many steps per stream, updating the
    stream's FilterState in place; a step that completes no revolution
    runs no filter step and leaves every FilterState plane untouched.
  * the de-skew half of the slots does not depend on the filter state:
    profiles (B4), motion estimates (B5) and the node corrections of every
    stream and every slot are computed at once, one launch each per step
    that completes a revolution; the carried profile and motion come from
    each stream's last live slot.
  * ``lax.scan`` over T ticks: a loop of the same tick function, so the
    carried map is updated in tick order.
  * the map update of a tick on which no stream has a live frame (the host
    staged the frames, so it knows) runs no launch: its wire reports the
    held pose, score 0, as the gated update would.

Node values are clamped like the host wire pack (dist 18 bits, quality 8,
flag 6), so the filter sees the host path's values.  Timestamps ride as
float32 offsets from a per-step base: each step re-bases the carried
partial's offsets by the base delta, so they stay bounded by one
revolution's span.

Arguments: ``frames`` is a uint8 tensor (moved to the state's device if it
is not there); ``aux`` is the float32 side plane of the JAX layout and is
read on the host (format, frame count, reset flag), so it should live in
host memory (pinned, for an asynchronous upload).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, ScanBatch
from rplidar_ros2_driver_tpu_torch.driver.decode import _PAIRED_NODES
from rplidar_ros2_driver_tpu_torch.ops import deskew as deskewmod
from rplidar_ros2_driver_tpu_torch.ops import unpack
from rplidar_ros2_driver_tpu_torch.ops.deskew import RECON_EMPTY, DeskewConfig
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    FilterConfig,
    FilterState,
    _filter_step_impl,
    _pack_output_wire,
    unpack_output_wire,
    wire_output_len,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    MapConfig,
    MapState,
    fleet_map_match_step,
)
from rplidar_ros2_driver_tpu_torch.protocol import timing as timingmod
from rplidar_ros2_driver_tpu_torch.protocol.constants import ANS_PAYLOAD_BYTES, Ans
from rplidar_ros2_driver_tpu_torch.utils import guards

_NPTS = timingmod.SAMPLES_PER_FRAME
_PAIRED = frozenset(_PAIRED_NODES)
_I32, _F32 = torch.int32, torch.float32

# widest payload over every wire format: the fleet's prev-frame carry is
# allocated at this width, so the state's shape never depends on formats
_FLEET_PREV_BYTES = max(int(v) for v in ANS_PAYLOAD_BYTES.values())


def _check_mapping_geometry(mapping, deskew) -> None:
    """The carried mapper consumes the reconstructed sweep: it needs the
    de-skew/reconstruction stage and that stage's beam grid."""
    if mapping is None:
        return
    if deskew is None:
        raise ValueError(
            "ingest mapping requires the de-skew/reconstruction stage "
            "(cfg.deskew): the reconstructed sweep is the mapper feed"
        )
    if mapping.beams != deskew.recon_beams:
        raise ValueError(
            f"ingest mapping beam grid ({mapping.beams}) must equal the "
            f"reconstruction beam grid ({deskew.recon_beams})"
        )


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Static configuration of one single-stream fused ingest step."""

    ans_type: int
    frame_bytes: int
    npts: int
    paired: bool
    grouped: bool            # per-sample grouping delay applies (timing)
    sample_duration_us: int  # rounded, as the decoders take it
    delay0_us: int           # back-dating of sample 0 (protocol/timing.py)
    max_nodes: int           # revolution overflow cap (head-keep)
    max_revs: int            # completed revolutions per step (newest win)
    emit_nodes: bool         # debug/parity: assembled node buffers returned
    filter: FilterConfig
    deskew: Optional[DeskewConfig] = None
    # the SLAM front-end inside the step (needs ``deskew``: the
    # reconstructed sweep is its feed)
    mapping: Optional[MapConfig] = None

    def __post_init__(self):
        _check_mapping_geometry(self.mapping, self.deskew)


def ingest_config_for(
    ans_type: int,
    timing: timingmod.TimingDesc,
    filter_cfg: FilterConfig,
    *,
    max_nodes: int = MAX_SCAN_NODES,
    max_revs: int = 2,
    emit_nodes: bool = False,
    deskew: Optional[DeskewConfig] = None,
    mapping=None,
) -> IngestConfig:
    """The static config for one (answer type, timing desc, chain)."""
    at = Ans(ans_type)
    return IngestConfig(
        ans_type=int(at),
        frame_bytes=ANS_PAYLOAD_BYTES[at],
        npts=_NPTS[at],
        paired=at in _PAIRED,
        grouped=at in timingmod._GROUPED_FORMATS,
        sample_duration_us=timing.sample_duration_int_us,
        delay0_us=timingmod.sample_delay_us(at, timing, 0),
        max_nodes=max_nodes,
        max_revs=max_revs,
        emit_nodes=emit_nodes,
        filter=filter_cfg,
        deskew=deskew,
        mapping=mapping,
    )


@dataclasses.dataclass
class IngestState:
    """Device-resident streaming state of the fused step (the JAX package's
    fields; every field gains a leading stream axis in the fleet state).
    A step returns a new IngestState; the FilterState it holds is updated
    in place, like the chain's."""

    filter: FilterState
    partial: torch.Tensor        # (max_nodes, 4) int32 current partial revolution
    partial_ts: torch.Tensor     # (max_nodes,) f32 offsets from the LAST base
    partial_len: torch.Tensor    # int32 (capped at max_nodes)
    seen_sync: torch.Tensor      # bool — data before the first sync is dropped
    sync_carry: torch.Tensor     # int32 — dense/ultra-dense edge-filter carry
    dist_carry: torch.Tensor     # int32 — ultra-dense smoothing carry
    prev_frame: torch.Tensor     # (frame_bytes,) uint8 — paired-format prev
    have_prev: torch.Tensor      # bool
    scans_completed: torch.Tensor  # int32, cumulative
    revs_dropped: torch.Tensor     # int32, cumulative
    # de-skew + reconstruction planes (cfg.deskew; None otherwise)
    recon_ring: Optional[torch.Tensor] = None    # (K, B) int32 sub-sweep ring
    recon_pos: Optional[torch.Tensor] = None     # int32 cumulative push count
    deskew_prof: Optional[torch.Tensor] = None   # (D,) int32 prev-rev profile
    deskew_motion: Optional[torch.Tensor] = None  # (3,) int32 [dx,dy,dθ_q16]
    # the carried MapState (cfg.mapping; None otherwise), updated in place
    map_log_odds: Optional[torch.Tensor] = None   # (G, G) int32 Q10
    map_pose: Optional[torch.Tensor] = None       # (3,) int32 [tx, ty, θidx]
    map_origin_xy: Optional[torch.Tensor] = None  # (2,) float32
    map_revision: Optional[torch.Tensor] = None   # int32


def _fresh_map_leaves(mcfg: Optional[MapConfig], lead: tuple, device) -> dict:
    """Fresh carried-map planes (MapState.create's values) with leading
    shape ``lead``; all None when mapping is off."""
    if mcfg is None:
        return dict(map_log_odds=None, map_pose=None, map_origin_xy=None, map_revision=None)
    z = dict(dtype=_I32, device=device)
    return dict(
        map_log_odds=torch.zeros(lead + (mcfg.grid, mcfg.grid), **z),
        map_pose=torch.zeros(lead + (3,), **z),
        map_origin_xy=torch.zeros(lead + (2,), dtype=_F32, device=device),
        map_revision=torch.zeros(lead, **z),
    )


def _carry_planes(lead: tuple, max_nodes: int, prev_bytes: int, dsk, device) -> dict:
    """Fresh decode/assembly/de-skew planes with leading shape ``lead``."""
    z = dict(dtype=_I32, device=device)
    return dict(
        partial=torch.zeros(lead + (max_nodes, 4), **z),
        partial_ts=torch.zeros(lead + (max_nodes,), dtype=_F32, device=device),
        partial_len=torch.zeros(lead, **z),
        seen_sync=torch.zeros(lead, dtype=torch.bool, device=device),
        sync_carry=torch.zeros(lead, **z),
        dist_carry=torch.zeros(lead, **z),
        prev_frame=torch.zeros(lead + (prev_bytes,), dtype=torch.uint8, device=device),
        have_prev=torch.zeros(lead, dtype=torch.bool, device=device),
        scans_completed=torch.zeros(lead, **z),
        revs_dropped=torch.zeros(lead, **z),
        # RECON_EMPTY (not zero) marks fresh ring/profile planes: a zero
        # cell would decode as a live dist-0 return
        recon_ring=(
            torch.full(lead + (dsk.recon_window, dsk.recon_beams), RECON_EMPTY, **z)
            if dsk is not None else None
        ),
        recon_pos=torch.zeros(lead, **z) if dsk is not None else None,
        deskew_prof=(
            torch.full(lead + (dsk.profile_beams,), RECON_EMPTY, **z)
            if dsk is not None else None
        ),
        deskew_motion=torch.zeros(lead + (3,), **z) if dsk is not None else None,
    )


def create_ingest_state(
    cfg: IngestConfig, filter_state: Optional[FilterState] = None, *, device="cpu"
) -> IngestState:
    """Fresh stream state on ``device``; ``filter_state`` carries the
    rolling window across scan-mode switches (only decode/assembly state
    resets, like the host path)."""
    device = torch.device(device)
    if filter_state is None:
        filter_state = FilterState.for_config(cfg.filter, device=device)
    return IngestState(
        filter=filter_state,
        **_carry_planes((), cfg.max_nodes, cfg.frame_bytes, cfg.deskew, device),
        **_fresh_map_leaves(cfg.mapping, (), device),
    )


# ---------------------------------------------------------------------------
# result layout — the JAX package's:
#
#   meta (float32, _META + 3*max_revs [+ _DESKEW_META]):
#     [0] n_completed  [1] revs_dropped_this_step  [2] syncs_in_batch
#     [3] nodes_appended
#     [4 : 4+R]        per-slot node counts          (R = max_revs)
#     [.. : ..+R]      per-slot ts0 offsets
#     [.. : ..+R]      per-slot end_ts offsets
#     (cfg.deskew only) [recon_pushed, recon_valid_beams, motion_dx_q2,
#       motion_dy_q2, motion_dθ_q16]
#   out_wires: (R, wire_output_len(filter)) float32
#   (cfg.deskew only) recon_plane (B,) int32 + recon_pts (B, 3) f32
#   (cfg.mapping only) map_wire (7,) int32:
#     [live, tx_sub, ty_sub, theta_idx, score, n_valid, revision]
#   (emit_nodes only) nodes (R, max_nodes, 4) f32 + node_ts (R, max_nodes)
# ---------------------------------------------------------------------------

_META = 4
_DESKEW_META = 5


def ingest_meta_len(cfg) -> int:
    return _META + 3 * cfg.max_revs + (_DESKEW_META if cfg.deskew is not None else 0)


@dataclasses.dataclass
class IngestBatchResult:
    """Host-side parse of one fused-step result (one stream)."""

    n_completed: int
    revs_dropped: int
    syncs: int
    nodes_appended: int
    counts: np.ndarray          # (n_completed,)
    ts0: np.ndarray             # (n_completed,) offsets (float32)
    end_ts: np.ndarray          # (n_completed,)
    outputs: list               # n_completed FilterOutput (numpy-backed)
    nodes: Optional[np.ndarray] = None      # (n_completed, max_nodes, 4)
    node_ts: Optional[np.ndarray] = None    # (n_completed, max_nodes)
    recon_plane: Optional[np.ndarray] = None  # (B,) int32 packed sweep
    recon_pts: Optional[np.ndarray] = None    # (B, 3) f32 [x, y, mask]
    recon_pushed: bool = False
    recon_valid: int = 0
    deskew_motion: Optional[np.ndarray] = None  # (3,) int32 estimate
    # the tick's map wire (cfg.mapping only)
    map_wire: Optional[np.ndarray] = None  # (7,) int32


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _live_wires(wires, n_completed: np.ndarray) -> Optional[np.ndarray]:
    """The (..., R, W) output wires on the host with only the rows of
    completed revolutions fetched (one gather, one copy; dead slots stay
    zero, as the step left them): None when nothing completed."""
    n = n_completed.reshape(-1).astype(np.int64)
    if not n.any():
        return None
    if not isinstance(wires, torch.Tensor):
        return np.asarray(wires)
    r, w = wires.shape[-2], wires.shape[-1]
    flat = wires.reshape(-1, w)
    # slices of the device plane (no index upload, which would synchronise)
    live = torch.cat([flat[i * r : i * r + k] for i, k in enumerate(n) if k]).cpu().numpy()
    out = np.zeros((flat.shape[0], w), np.float32)
    out[np.concatenate([i * r + np.arange(k) for i, k in enumerate(n) if k])] = live
    return out.reshape(tuple(wires.shape))


def _parse_row(mrow, wires, nodes, node_ts, cfg, recon_plane=None, recon_pts=None,
               map_wire=None):
    """One stream's IngestBatchResult from its meta row and result planes
    (``wires`` only touched when the row completed revolutions)."""
    r = cfg.max_revs
    n = int(mrow[0])
    counts = mrow[_META : _META + r].astype(np.int32)
    kw = {}
    if cfg.deskew is not None:
        doff = _META + 3 * r
        kw = dict(
            recon_pushed=bool(mrow[doff] > 0.5),
            recon_valid=int(mrow[doff + 1]),
            deskew_motion=mrow[doff + 2 : doff + 5].astype(np.int32),
            recon_plane=recon_plane,
            recon_pts=recon_pts,
        )
    if cfg.mapping is not None:
        kw["map_wire"] = np.asarray(map_wire, np.int32)
    return IngestBatchResult(
        n_completed=n,
        revs_dropped=int(mrow[1]),
        syncs=int(mrow[2]),
        nodes_appended=int(mrow[3]),
        counts=counts[:n],
        ts0=mrow[_META + r : _META + 2 * r][:n].copy(),
        end_ts=mrow[_META + 2 * r : _META + 3 * r][:n].copy(),
        outputs=[unpack_output_wire(wires[k], cfg.filter) for k in range(n)],
        nodes=nodes.astype(np.int32)[:n] if nodes is not None else None,
        node_ts=node_ts[:n] if node_ts is not None else None,
        **kw,
    )


def _split_result(res, cfg) -> tuple:
    """(meta, wires, recon_plane, recon_pts, map_wire, nodes, node_ts) of a
    result tuple — the one result-arity rule (:func:`_core_outputs`)."""
    meta, wires = res[0], res[1]
    idx = 2
    rp = rpts = mw = nodes = nts = None
    if cfg.deskew is not None:
        rp, rpts = res[idx], res[idx + 1]
        idx += 2
    if cfg.mapping is not None:
        mw = res[idx]
        idx += 1
    if cfg.emit_nodes:
        nodes, nts = res[idx], res[idx + 1]
    return meta, wires, rp, rpts, mw, nodes, nts


def unpack_ingest_result(res, cfg: IngestConfig) -> IngestBatchResult:
    """Host-side parse of the single-stream step's result tensors
    ``(meta, out_wires[, recon_plane, recon_pts][, map_wire][, nodes,
    node_ts])``.  Only the wire rows of completed revolutions are
    fetched."""
    meta, wires, rp, rpts, mw, nodes, nts = _split_result(res, cfg)
    meta = _np(meta)
    if meta.size != ingest_meta_len(cfg):
        raise ValueError(
            f"ingest meta of {meta.size} floats does not match cfg "
            f"(expected {ingest_meta_len(cfg)})"
        )
    return _parse_row(
        meta,
        _live_wires(wires, meta[:1]),
        _np(nodes) if nodes is not None else None,
        _np(nts) if nts is not None else None,
        cfg,
        _np(rp) if rp is not None else None,
        _np(rpts) if rpts is not None else None,
        _np(mw) if mw is not None else None,
    )


# ---------------------------------------------------------------------------
# decode of one stream's frames
# ---------------------------------------------------------------------------


def _wire_clamp(angle, dist, quality, flag):
    """The host wire pack's clamps (dist saturates at 18 bits — a
    'negative' int32 bit pattern from the HQ u32 field saturates too —
    quality to 8 bits, flag to 6, angle to u16)."""
    angle = angle & 0xFFFF
    dist = torch.where(dist < 0, 0x3FFFF, dist.clamp(max=0x3FFFF))
    return angle, dist, quality & 0xFF, flag & 0x3F


def _decode_frames(at: Ans, frames, prev, crc_ok, sync_carry, dist_carry, dur: int):
    """One format's decoder over ``frames`` (m, payload) uint8, the prev
    frame prepended for the paired formats and the carries passed as
    device values (driver/decode.py threads the same carries as ints)."""
    if at == Ans.MEASUREMENT:
        return unpack.unpack_normal_nodes(frames)
    if at == Ans.MEASUREMENT_HQ:
        return unpack.unpack_hq_capsules(frames, crc_ok)
    fr = torch.cat([prev[None], frames], dim=0)
    if at == Ans.MEASUREMENT_CAPSULED:
        return unpack.unpack_capsules(fr)
    if at == Ans.MEASUREMENT_CAPSULED_ULTRA:
        return unpack.unpack_ultra_capsules(fr)
    if at == Ans.MEASUREMENT_DENSE_CAPSULED:
        return unpack.unpack_dense_capsules(fr, sync_carry, sample_duration_us=dur)
    if at == Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED:
        # the smoothing recurrence runs on the host (ops/unpack._ud_smooth):
        # one synchronisation per step for this format
        return unpack.unpack_ultra_dense_capsules(
            fr, sync_carry, dist_carry, sample_duration_us=dur
        )
    raise ValueError(f"unsupported ans type {int(at):#x}")


def _decode_lane(at: Ans, frames, rx, crc_ok, prev, have_prev, sync_carry, dist_carry,
                 dur: int, delay0_us: int):
    """Decode + carries + stamps of one stream's ``m >= 1`` live frames.

    Returns ``(angle, dist, quality, flag, valid, ts, new_sync,
    new_dist)``: (m, npts) planes (``valid`` row-uniform) and the carries
    for the next step (single-stream step semantics)."""
    npts = _NPTS[at]
    m = frames.shape[0]
    dec = _decode_frames(at, frames, prev, crc_ok, sync_carry, dist_carry, dur)
    angle, dist, quality, flag = dec.angle_q14, dec.dist_q2, dec.quality, dec.flag
    valid_row = dec.node_valid[:, 0]
    if at in _PAIRED:
        # pair i = (fr[i], fr[i+1]) with the prev frame at fr[0]: a zeroed
        # prev fails the checksum, but the explicit mask also covers it
        rows = torch.arange(m, device=frames.device)
        valid_row = valid_row & (have_prev | (rows > 0))
    new_sync, new_dist = sync_carry, dist_carry
    if at in (Ans.MEASUREMENT_DENSE_CAPSULED, Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED):
        new_sync = flag[m - 1, -1] & 1
    if at == Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED:
        d_flat = dist.reshape(-1)
        v_flat = valid_row.repeat_interleave(npts)
        vidx = torch.where(v_flat, torch.arange(d_flat.shape[0], device=d_flat.device), -1)
        li = vidx.max()
        new_dist = torch.where(li >= 0, d_flat[li.clamp(min=0)], dist_carry)
    # per-node timestamps (protocol/timing.frame_sample_times, f32):
    # first + step·i rounded once, as XLA's fused multiply-add gives it
    # (an f32 step times a small int is exact in float64).  The Python
    # float operand is rounded to float32 by the subtraction; a device
    # tensor built from it would synchronise the stream.
    dev = rx.device
    first = rx - float(np.float32(delay0_us * 1e-6))
    step = float(np.float32(dur * 1e-6 if at in timingmod._GROUPED_FORMATS else 0.0))
    i = torch.arange(npts, dtype=torch.float64, device=dev)
    ts = (first.double()[:, None] + step * i[None, :]).to(_F32)
    valid = valid_row[:, None].expand(m, npts)
    return angle, dist, quality, flag, valid, ts, new_sync, new_dist


def _compact(angle, dist, quality, flag, valid, ts):
    """Node-level validity compaction of (N, mb, P) planes: a stable sort
    on the node mask puts each stream's valid nodes first, order kept.
    Returns ((N, n, 4) int32 nodes, (N, n) f32 stamps, (N,) int32 count)."""
    n_streams = angle.shape[0]
    angle, dist, quality, flag = _wire_clamp(angle, dist, quality, flag)
    v = valid.reshape(n_streams, -1)
    order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
    nv = v.sum(dim=1, dtype=_I32)
    batch4 = torch.stack([angle, dist, quality, flag], dim=-1).reshape(n_streams, -1, 4)
    batch4 = torch.gather(batch4, 1, order[..., None].expand(batch4.shape))
    ts_c = torch.gather(ts.reshape(n_streams, -1), 1, order)
    return batch4, ts_c, nv


# ---------------------------------------------------------------------------
# the shared segmentation / de-skew / filter core
# ---------------------------------------------------------------------------


class _CoreResult(NamedTuple):
    """The advanced stream planes (leading stream axis) and the result
    tensors of one step."""

    partial: torch.Tensor
    partial_ts: torch.Tensor
    partial_len: torch.Tensor
    seen_sync: torch.Tensor
    n_completed: torch.Tensor
    drop_head: torch.Tensor
    meta: torch.Tensor
    out_wires: torch.Tensor
    nodes: Optional[torch.Tensor]
    node_ts: Optional[torch.Tensor]
    recon_ring: Optional[torch.Tensor] = None
    recon_pos: Optional[torch.Tensor] = None
    deskew_prof: Optional[torch.Tensor] = None
    deskew_motion: Optional[torch.Tensor] = None
    recon_plane: Optional[torch.Tensor] = None
    recon_pts: Optional[torch.Tensor] = None
    # per-stream completed counts as host ints (the step's one
    # synchronisation already fetched them)
    n_host: Optional[list] = None


def _segment_filter_core(cfg, st: IngestState, filters: list, batch4, ts_c, nv,
                         base_shift) -> _CoreResult:
    """Append the compacted node stream to each stream's carried partial
    revolution, segment at the sync bits, de-skew, and run one filter step
    per completed revolution.

    ``st`` holds stream-batched planes (leading axis N); ``filters`` the N
    per-stream FilterStates, updated in place.  ``batch4``/``ts_c`` are
    the (N, n, 4)/(N, n) compacted nodes, ``nv`` the (N,) live counts and
    ``base_shift`` the (N,) re-base shifts.  ``cfg`` needs only the
    fields IngestConfig and FleetIngestConfig share."""
    mn, big_r = cfg.max_nodes, cfg.max_revs
    n_streams, n = batch4.shape[0], batch4.shape[1]
    dev = batch4.device
    i64 = torch.int64

    # -- one contiguous stream buffer per stream: [0, mn) the carried
    # partial, the batch appended at partial_len, a trailing mn of zeros so
    # every fixed-length revolution slice stays in bounds
    big_l = 2 * mn + n
    plen = st.partial_len.to(i64)
    pos = plen[:, None] + torch.arange(n, device=dev)            # (N, n)
    full4 = torch.zeros((n_streams, big_l, 4), dtype=_I32, device=dev)
    full4[:, :mn] = st.partial
    full4.scatter_(1, pos[..., None].expand(n_streams, n, 4), batch4)
    fullts = torch.zeros((n_streams, big_l), dtype=_F32, device=dev)
    # the carried offsets were relative to the PREVIOUS step's base
    fullts[:, :mn] = st.partial_ts + base_shift[:, None]
    fullts.scatter_(1, pos, ts_c)
    total = st.partial_len + nv
    flag_c = batch4[..., 3]

    # -- de-skew + sweep reconstruction: the tick's fresh nodes, de-skewed
    # with the CARRIED motion, become one sub-sweep segment per stream (one
    # B4 launch for all streams); every valid node of the tick enters it
    dsk = cfg.deskew
    recon = {}
    if dsk is not None:
        live_b = torch.arange(n, device=dev)[None, :] < nv[:, None]
        a_ds, d_ds = deskewmod.apply_deskew(
            batch4[..., 0], batch4[..., 1], live_b, st.deskew_motion, dsk
        )
        seg = deskewmod.rasterize_subsweep(a_ds, d_ds, batch4[..., 2], live_b, dsk)
        pushed = nv > 0
        ring, rpos = deskewmod.push_ring(st.recon_ring, st.recon_pos, seg, pushed)
        plane = deskewmod.combine_ring(ring, rpos)
        _rr, rxy, rmask = deskewmod.recon_points(plane)
        recon = dict(
            recon_ring=ring, recon_pos=rpos, recon_plane=plane,
            recon_pts=torch.cat([rxy, rmask.to(_F32)[..., None]], dim=-1),
        )

    # -- revolution segmentation: sync-bit cumsum + searchsorted starts --
    j = torch.arange(n, device=dev)
    live_j = j[None, :] < nv[:, None]
    s_c = live_j & ((flag_c & 1) == 1)
    psum = torch.cumsum(s_c.to(_I32), dim=1, dtype=_I32)         # syncs at-or-before j
    syncs = psum[:, -1]
    seen = st.seen_sync
    k0 = torch.where(seen, 0, 1).to(_I32)                         # first completable id
    n_completed_raw = (syncs - k0).clamp(min=0)
    drop_head = (n_completed_raw - big_r).clamp(min=0)
    n_completed = n_completed_raw.clamp(max=big_r)
    # segment q's start: position of the q-th sync; segment 0 starts at 0
    q = (k0 + drop_head)[:, None] + torch.arange(big_r + 1, dtype=_I32, device=dev)
    qs = torch.cat([q, syncs[:, None]], dim=1)
    jq = torch.searchsorted(psum, qs, side="left")
    starts = torch.where(qs == 0, 0, plen[:, None] + jq)        # (N, R+2) int64
    seg_start = starts[:, : big_r + 1]
    open_start = starts[:, -1]
    slot = torch.arange(big_r, device=dev)
    live_slot = slot[None, :] < n_completed[:, None]
    counts = torch.where(
        live_slot, (seg_start[:, 1:] - seg_start[:, :-1]).clamp(max=mn), 0
    ).to(_I32)
    # ts0 = first node of the slot; end_ts = the sync node CLOSING it
    ts0 = torch.where(counts > 0, fullts.gather(1, seg_start[:, :big_r]), 0.0)
    end_ts = torch.where(live_slot, fullts.gather(1, seg_start[:, 1:]), 0.0)

    # -- the carried partial: the open segment's head (max_nodes cap) --
    keep_p = seen | (syncs > 0)                                   # pre-first-sync dropped
    cnt_p = torch.where(keep_p, (total - open_start).clamp(max=mn), 0).to(_I32)
    win = open_start[:, None] + torch.arange(mn, device=dev)     # (N, mn)
    pmask = torch.arange(mn, device=dev)[None, :] < cnt_p[:, None]
    new_partial = torch.where(
        pmask[..., None], full4.gather(1, win[..., None].expand(n_streams, mn, 4)), 0
    )
    new_partial_ts = torch.where(pmask, fullts.gather(1, win), 0.0)

    # nodes that actually landed (stat parity with the host decoder):
    # valid, within the head-keep cap, in a kept segment
    last_sync_j = torch.cummax(torch.where(s_c, j[None, :], -1), dim=1).values
    seg_begin_j = torch.where(last_sync_j >= 0, plen[:, None] + last_sync_j, 0)
    pos_j = plen[:, None] + j[None, :] - seg_begin_j
    rel = psum - (k0 + drop_head)[:, None]
    kept = torch.where(
        psum == syncs[:, None], keep_p[:, None],
        (rel >= 0) & (rel < n_completed[:, None]),
    )
    nodes_appended = (live_j & (pos_j < mn) & kept).sum(dim=1, dtype=_I32)

    # -- the revolution slots.  The completed counts come to the host once
    # (the step's one synchronisation); every stream then runs exactly its
    # count of filter steps, so a dead slot never touches a FilterState
    fcfg = cfg.filter
    wire_len = wire_output_len(fcfg)
    out_wires = torch.zeros((n_streams, big_r, wire_len), dtype=_F32, device=dev)
    with guards.declared_sync():
        n_host = n_completed.cpu().tolist()
    new_prof, new_motion = st.deskew_prof, st.deskew_motion
    nodes_arr = ts_arr = None
    if sum(n_host) or cfg.emit_nodes:
        iota = torch.arange(mn, device=dev)
        idx = seg_start[:, :big_r, None] + iota                 # (N, R, mn)
        lv = iota < counts[..., None]
        nodes_all = full4.gather(
            1, idx.reshape(n_streams, -1, 1).expand(n_streams, big_r * mn, 4)
        ).reshape(n_streams, big_r, mn, 4)
        nodes_all = torch.where(lv[..., None], nodes_all, 0)
        if cfg.emit_nodes:
            nodes_arr = nodes_all.to(_F32)
            ts_arr = torch.where(lv, fullts.gather(1, idx.reshape(n_streams, -1)).reshape(
                n_streams, big_r, mn), 0.0)
    if sum(n_host):
        new_prof, new_motion = _revolution_slots(
            filters, nodes_all, lv, counts, n_completed, n_host, st, cfg, out_wires)

    meta = torch.cat([
        torch.stack([n_completed, drop_head, syncs, nodes_appended], dim=1).to(_F32),
        counts.to(_F32), ts0, end_ts,
    ], dim=1)
    if dsk is not None:
        recon_valid = (recon["recon_plane"] != RECON_EMPTY).sum(dim=1, dtype=_I32)
        meta = torch.cat([
            meta,
            torch.stack([(nv > 0).to(_I32), recon_valid, new_motion[:, 0],
                         new_motion[:, 1], new_motion[:, 2]], dim=1).to(_F32),
        ], dim=1)
    return _CoreResult(
        partial=new_partial, partial_ts=new_partial_ts, partial_len=cnt_p,
        seen_sync=keep_p, n_completed=n_completed, drop_head=drop_head,
        meta=meta, out_wires=out_wires, nodes=nodes_arr, node_ts=ts_arr,
        deskew_prof=new_prof, deskew_motion=new_motion, n_host=n_host, **recon,
    )


def _revolution_slots(filters: list, nodes_all, lv, counts, n_completed, n_host: list,
                      st: IngestState, cfg: FleetIngestConfig, out_wires):
    """What only a COMPLETED revolution runs, for every stream's live
    slots: the per-revolution range-only de-skew (B4, B5) and the slot
    filter (B1, or B2 for ``inc``), each slot's wire packed into
    ``out_wires`` in place and ``filters[s]`` advanced.  Returns the
    de-skew carries (profile, motion)."""
    dsk = cfg.deskew
    angle_r, dist_r = nodes_all[..., 0], nodes_all[..., 1]
    new_prof, new_motion = st.deskew_prof, st.deskew_motion
    if dsk is not None:
        # per-revolution range-only de-skew for every stream and slot at
        # once: profile each slot RAW (one B4 launch), estimate its
        # motion against the previous slot's profile — the carried one
        # for slot 0 — (one B5 launch), re-project its nodes
        prof_rows = deskewmod.profile_from_nodes(angle_r, dist_r, lv, dsk)
        prev = torch.cat([st.deskew_prof[:, None], prof_rows[:, :-1]], dim=1)
        motion_rows = deskewmod.estimate_motion(prev, prof_rows, dsk)
        angle_r, dist_r = deskewmod.apply_deskew(angle_r, dist_r, lv, motion_rows, dsk)
        # the carries come from each stream's LAST live slot
        has = n_completed > 0
        last = (n_completed - 1).clamp(min=0).long()
        rows = torch.arange(n_completed.shape[0], device=n_completed.device)
        new_prof = torch.where(has[:, None], prof_rows[rows, last], st.deskew_prof)
        new_motion = torch.where(has[:, None], motion_rows[rows, last], st.deskew_motion)
    for s, k_s in enumerate(n_host):
        for r in range(k_s):
            batch = ScanBatch(
                angle_q14=angle_r[s, r], dist_q2=dist_r[s, r],
                quality=nodes_all[s, r, :, 2], flag=nodes_all[s, r, :, 3],
                valid=lv[s, r], count=counts[s, r],
            )
            filters[s], out = _filter_step_impl(filters[s], batch, cfg.filter)
            out_wires[s, r] = _pack_output_wire(out)
    return new_prof, new_motion


def _core_outputs(cfg, core: _CoreResult, map_wire=None, lane=slice(None)) -> tuple:
    """The one result-arity rule: ``(meta, out_wires[, recon_plane,
    recon_pts][, map_wire][, nodes, node_ts])``; ``lane`` selects the
    stream axis (index 0 for the single-stream step)."""
    out = [core.meta[lane], core.out_wires[lane]]
    if cfg.deskew is not None:
        out += [core.recon_plane[lane], core.recon_pts[lane]]
    if cfg.mapping is not None:
        out += [map_wire[lane]]
    if cfg.emit_nodes:
        out += [core.nodes[lane], core.node_ts[lane]]
    return tuple(out)


def _map_update_tick(cfg, st: IngestState, core: _CoreResult, nv, any_live: bool):
    """The carried SLAM front-end tick (cfg.mapping) for every stream at
    once: match each stream's reconstructed sweep against its carried map
    and absorb it (ops/scan_match.fleet_map_match_step — the step the
    host-route FleetMapper runs separately), gated on the tick pushing a
    sub-sweep (``live = nv > 0``, take_recon's freshness rule), so an idle
    stream's map and pose pass through untouched.  The MapState is a view
    of the carry's planes, so its in-place update is the carry's.

    ``any_live`` is the host's knowledge that some stream staged a frame
    this tick; without one nothing can push, and the launches are skipped.
    Returns the (N, 7) int32 map wire ``[live, tx_sub, ty_sub, theta_idx,
    score, n_valid, revision]``."""
    mstate = MapState(log_odds=st.map_log_odds, pose=st.map_pose,
                      origin_xy=st.map_origin_xy, revision=st.map_revision)
    live = (nv > 0).to(_I32)
    if any_live:
        pts = core.recon_pts
        _, wire5 = fleet_map_match_step(mstate, pts[..., :2], pts[..., 2] > 0.5, live,
                                        cfg.mapping)
    else:
        zero = torch.zeros_like(live)[:, None]
        wire5 = torch.cat([mstate.pose, zero, zero], dim=1)
    return torch.cat([live[:, None], wire5, mstate.revision[:, None]], dim=1)


def _advance(st: IngestState, core: _CoreResult, filt, sync, dist, prev, have) -> IngestState:
    """The next stream-batched state from a core result and new carries."""
    return IngestState(
        filter=filt,
        partial=core.partial,
        partial_ts=core.partial_ts,
        partial_len=core.partial_len,
        seen_sync=core.seen_sync,
        sync_carry=sync,
        dist_carry=dist,
        prev_frame=prev,
        have_prev=have,
        scans_completed=st.scans_completed + core.n_completed,
        revs_dropped=st.revs_dropped + core.drop_head,
        recon_ring=core.recon_ring,
        recon_pos=core.recon_pos,
        deskew_prof=core.deskew_prof,
        deskew_motion=core.deskew_motion,
        map_log_odds=st.map_log_odds,
        map_pose=st.map_pose,
        map_origin_xy=st.map_origin_xy,
        map_revision=st.map_revision,
    )


def _to_device(frames, dev: torch.device) -> torch.Tensor:
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.require(frames, np.uint8, requirements="W"))
    return frames.to(dev, non_blocking=True)


def _aux_pair(aux, dev: torch.device) -> tuple:
    """(host numpy, device tensor) views of the aux plane: the host copy is
    read for formats, frame counts and resets, the device copy for stamps
    and CRC verdicts (non-blocking from pinned memory)."""
    if isinstance(aux, torch.Tensor):
        if aux.device.type != "cpu":
            raise ValueError("aux must live in host memory (it is read on the host)")
        return aux.numpy(), aux.to(dev, non_blocking=True)
    host = np.asarray(aux, np.float32)
    return host, torch.from_numpy(host.copy()).to(dev)


def fused_ingest_step(state: IngestState, frames, aux, cfg: IngestConfig) -> tuple:
    """One frame batch through unpack -> segment -> de-skew -> filter (->
    the carried map).  Returns ``(state, meta, out_wires[, recon_plane,
    recon_pts][, map_wire][, nodes, node_ts])`` (see
    :func:`fused_ingest_step_counted`)."""
    new, results, _n = fused_ingest_step_counted(state, frames, aux, cfg)
    return (new,) + results


def fused_ingest_step_counted(state: IngestState, frames, aux, cfg: IngestConfig) -> tuple:
    """One frame batch through unpack -> segment -> de-skew -> filter.

    ``frames`` is (M, frame_bytes) uint8, zero-padded past the live count;
    ``aux`` is (2M+2,) float32 in host memory: per-frame rx offsets from
    THIS batch's base stamp, per-frame CRC verdicts (HQ only), the
    previous base minus this base, and the live frame count last.  Returns
    ``(state, (meta, out_wires[, recon_plane, recon_pts][, map_wire][,
    nodes, node_ts]), n_completed)``, the count as a host int (so a caller
    copies just the completed rows of ``out_wires`` to the host without
    another synchronisation); ``state.filter`` and the carried map are
    updated in place."""
    dev = state.partial.device
    frames = _to_device(frames, dev)
    aux_h, aux_d = _aux_pair(aux, dev)
    mb = frames.shape[0]
    m = int(aux_h[-1])
    at = Ans(cfg.ans_type)
    planes = _empty_planes(1, mb, cfg.npts, dev)
    sync, dist = state.sync_carry, state.dist_carry
    prev, have = state.prev_frame, state.have_prev
    if m > 0:
        lane = _decode_lane(
            at, frames[:m], aux_d[:m], aux_d[mb : mb + m] > 0.5, state.prev_frame,
            state.have_prev, state.sync_carry, state.dist_carry,
            cfg.sample_duration_us, cfg.delay0_us,
        )
        for plane, val in zip(planes, lane[:6]):
            plane[0, :m] = val
        sync, dist = lane[6], lane[7]
        if cfg.paired:
            prev = frames[m - 1].clone()
            have = torch.ones_like(state.have_prev)
    batch4, ts_c, nv = _compact(*planes)
    lanes = _map_planes(state, lambda a: a[None])
    filters = [state.filter]
    core = _segment_filter_core(cfg, lanes, filters, batch4, ts_c, nv, aux_d[-2:-1])
    map_wire = None
    if cfg.mapping is not None:
        map_wire = _map_update_tick(cfg, lanes, core, nv, m > 0)
    new = _map_planes(_advance(lanes, core, filters[0], sync, dist, prev, have),
                      lambda a: a[0], skip=("sync_carry", "dist_carry", "prev_frame", "have_prev"))
    return new, _core_outputs(cfg, core, map_wire, 0), core.n_host[0]


def _map_planes(state: IngestState, fn, skip=()) -> IngestState:
    """``state`` with ``fn`` applied to every plane but the FilterState,
    None planes and ``skip`` (the single-stream step's stream axis)."""
    return IngestState(**{
        f.name: v if f.name == "filter" or f.name in skip or v is None else fn(v)
        for f in dataclasses.fields(state)
        for v in (getattr(state, f.name),)
    })


def _empty_planes(n_streams: int, mb: int, p: int, dev) -> list:
    """Zeroed (N, mb, P) decode planes: angle, dist, quality, flag (int32),
    valid (bool), stamps (f32) — idle and padded lanes stay dead."""
    shape = (n_streams, mb, p)
    return [torch.zeros(shape, dtype=_I32, device=dev) for _ in range(4)] + [
        torch.zeros(shape, dtype=torch.bool, device=dev),
        torch.zeros(shape, dtype=_F32, device=dev),
    ]


# ---------------------------------------------------------------------------
# fleet lowering: one step per fleet tick, N streams on the batch axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetIngestConfig:
    """Static configuration of one fleet step.  ``formats`` is the tuple
    of answer types it decodes (each stream names its branch per tick in
    ``aux``); ``frame_bytes``/``npts`` are the maxima over ``formats``."""

    formats: tuple
    frame_bytes: int
    npts: int
    sample_duration_us: int
    delay0_us: tuple         # per-format back-dating of sample 0, formats order
    max_nodes: int
    max_revs: int
    emit_nodes: bool
    filter: FilterConfig
    deskew: Optional[DeskewConfig] = None
    # the SLAM front-end inside the step (needs ``deskew``: the
    # reconstructed sweep is its feed)
    mapping: Optional[MapConfig] = None

    def __post_init__(self):
        _check_mapping_geometry(self.mapping, self.deskew)


def fleet_ingest_config_for(
    formats,
    timing: timingmod.TimingDesc,
    filter_cfg: FilterConfig,
    *,
    max_nodes: int = MAX_SCAN_NODES,
    max_revs: int = 2,
    emit_nodes: bool = False,
    deskew: Optional[DeskewConfig] = None,
    mapping=None,
) -> FleetIngestConfig:
    """The static config for one (format set, timing desc, chain)."""
    ats = tuple(Ans(a) for a in dict.fromkeys(formats))
    if not ats:
        raise ValueError("fleet ingest needs at least one wire format")
    return FleetIngestConfig(
        formats=tuple(int(a) for a in ats),
        frame_bytes=max(ANS_PAYLOAD_BYTES[a] for a in ats),
        npts=max(_NPTS[a] for a in ats),
        sample_duration_us=timing.sample_duration_int_us,
        delay0_us=tuple(timingmod.sample_delay_us(a, timing, 0) for a in ats),
        max_nodes=max_nodes,
        max_revs=max_revs,
        emit_nodes=emit_nodes,
        filter=filter_cfg,
        deskew=deskew,
        mapping=mapping,
    )


def create_fleet_ingest_state(
    cfg: FleetIngestConfig, streams: int, filter_state=None, *, device="cpu"
) -> IngestState:
    """Stream-batched :class:`IngestState`: a leading ``(streams,)`` axis on
    every plane.  ``filter_state`` (stream-batched) carries the rolling
    windows across scan-mode switches; the prev-frame plane has the global
    max payload width, so the state's shape is format-independent."""
    device = torch.device(device)
    if filter_state is None:
        per = FilterState.for_config(cfg.filter, device=device)
        filter_state = FilterState(**{
            f.name: (None if getattr(per, f.name) is None
                     else getattr(per, f.name)[None].repeat(
                         (streams,) + (1,) * getattr(per, f.name).ndim))
            for f in dataclasses.fields(per)
        })
    return IngestState(
        filter=filter_state,
        **_carry_planes((streams,), cfg.max_nodes, _FLEET_PREV_BYTES, cfg.deskew, device),
        **_fresh_map_leaves(cfg.mapping, (streams,), device),
    )


def fleet_aux_len(max_frames: int) -> int:
    """Per-stream aux row length for a ``max_frames`` bucket: rx offsets,
    CRC verdicts, then [base_shift, m, branch, reset]."""
    return 2 * max_frames + 4


def _reset_stream_decode(state: IngestState, reset) -> IngestState:
    """Zero the decode/assembly carries of the streams flagged in the (N,)
    bool ``reset`` (scan-mode change, engine-level reset); the rolling
    filter windows, the carried maps and the cumulative stats survive.
    The sub-sweep ring and profile restart EMPTY: a format switch never
    stitches reconstructed sweeps across the discontinuity."""
    def rz(a):
        return torch.where(reset.reshape((-1,) + (1,) * (a.ndim - 1)), torch.zeros_like(a), a)

    def re(a):
        return None if a is None else torch.where(
            reset.reshape((-1,) + (1,) * (a.ndim - 1)), torch.full_like(a, RECON_EMPTY), a
        )

    return dataclasses.replace(
        state,
        partial=rz(state.partial),
        partial_ts=rz(state.partial_ts),
        partial_len=rz(state.partial_len),
        seen_sync=state.seen_sync & ~reset,
        sync_carry=rz(state.sync_carry),
        dist_carry=rz(state.dist_carry),
        prev_frame=rz(state.prev_frame),
        have_prev=state.have_prev & ~reset,
        recon_ring=re(state.recon_ring),
        recon_pos=None if state.recon_pos is None else rz(state.recon_pos),
        deskew_prof=re(state.deskew_prof),
        deskew_motion=None if state.deskew_motion is None else rz(state.deskew_motion),
    )


def _stream_filter(fs: FilterState, s: int) -> FilterState:
    """Stream ``s``'s FilterState as views into the batched one: the
    step's in-place updates land in the batched tensors."""
    return FilterState(**{
        f.name: None if getattr(fs, f.name) is None else getattr(fs, f.name)[s]
        for f in dataclasses.fields(fs)
    })


def _fleet_tick(cfg: FleetIngestConfig, state: IngestState, frames, aux_h, aux_d) -> tuple:
    """One fleet tick: per-stream decode of the live lanes (each with its
    format's decoder), node-level compaction, then the shared core for
    all streams.  Shared by the per-tick step and the super-step."""
    n_streams, mb = frames.shape[0], frames.shape[1]
    dev = frames.device
    m = aux_h[:, 2 * mb + 1].astype(np.int64)
    branch = np.clip(aux_h[:, 2 * mb + 2].astype(np.int64), 0, len(cfg.formats) - 1)
    if (aux_h[:, 2 * mb + 3] > 0.5).any():
        state = _reset_stream_decode(state, aux_d[:, 2 * mb + 3] > 0.5)

    planes = _empty_planes(n_streams, mb, cfg.npts, dev)
    sync, dist = state.sync_carry.clone(), state.dist_carry.clone()
    prev, have = state.prev_frame.clone(), state.have_prev.clone()
    for s in np.flatnonzero(m > 0).tolist():
        k, ms = int(branch[s]), int(m[s])
        at = Ans(cfg.formats[k])
        fb, npts = ANS_PAYLOAD_BYTES[at], _NPTS[at]
        lane = _decode_lane(
            at, frames[s, :ms, :fb], aux_d[s, :ms], aux_d[s, mb : mb + ms] > 0.5,
            state.prev_frame[s, :fb], state.have_prev[s], state.sync_carry[s],
            state.dist_carry[s], cfg.sample_duration_us, cfg.delay0_us[k],
        )
        # narrower formats leave the pad columns dead (valid=False, stamp 0)
        for plane, val in zip(planes, lane[:6]):
            plane[s, :ms, :npts] = val
        sync[s], dist[s] = lane[6], lane[7]
        if at in _PAIRED:
            # fill_, not ``= value``: assigning a Python scalar into a CUDA
            # tensor copies it from the host and synchronises the stream
            prev[s].zero_()
            prev[s, : frames.shape[2]] = frames[s, ms - 1]
            have[s].fill_(True)
    batch4, ts_c, nv = _compact(*planes)
    filters = [_stream_filter(state.filter, s) for s in range(n_streams)]
    core = _segment_filter_core(cfg, state, filters, batch4, ts_c, nv, aux_d[:, 2 * mb])
    if state.filter.median_sorted is not None:
        # the incremental median replaces (not updates) the sorted window
        for s, f in enumerate(filters):
            state.filter.median_sorted[s].copy_(f.median_sorted)
    map_wire = None
    if cfg.mapping is not None:
        map_wire = _map_update_tick(cfg, state, core, nv, bool((m > 0).any()))
    new = _advance(state, core, state.filter, sync, dist, prev, have)
    return (new,) + _core_outputs(cfg, core, map_wire)


def fleet_fused_ingest_step(state: IngestState, frames, aux, cfg: FleetIngestConfig) -> tuple:
    """One fleet tick through the whole ingest pipeline.

    ``frames`` is (streams, M, frame_bytes) uint8, zero-padded past each
    stream's live count and each narrower format's payload; ``aux`` is
    (streams, 2M+4) float32 in host memory per :func:`fleet_aux_len`: rx
    offsets from the stream's own base, CRC verdicts (HQ only), then
    [re-base shift, live frame count, format branch, decode-reset flag].
    Returns ``(state, meta, out_wires[, recon_plane, recon_pts][,
    map_wire][, nodes, node_ts])`` with a leading stream axis on every
    result; the FilterStates and carried maps are updated in place."""
    dev = state.partial.device
    frames = _to_device(frames, dev)
    aux_h, aux_d = _aux_pair(aux, dev)
    return _fleet_tick(cfg, state, frames, aux_h, aux_d)


def super_fleet_ingest_step(state: IngestState, frames, aux, cfg: FleetIngestConfig) -> tuple:
    """T fleet ticks in one call: ``frames`` (T, streams, M, frame_bytes)
    and ``aux`` (T, streams, 2M+4), uploaded once, then a loop of the
    per-tick function — exact against T per-tick calls.  An all-idle tick
    plane (every stream m=0, reset=0, base_shift=0) passes every carry
    through, so a short backlog pads to a fixed T.  Returns ``(state,
    meta, out_wires, ...)`` with a leading (T, streams) axis pair."""
    dev = state.partial.device
    frames = _to_device(frames, dev)
    aux_h, aux_d = _aux_pair(aux, dev)
    per_tick = []
    for t in range(frames.shape[0]):
        state, *res = _fleet_tick(cfg, state, frames[t], aux_h[t], aux_d[t])
        per_tick.append(res)
    return (state,) + tuple(torch.stack(col) for col in zip(*per_tick))


def warm_revolution_path(cfg: FleetIngestConfig, streams: int, device: torch.device) -> None:
    """Run :func:`_revolution_slots` once — the code a COMPLETED revolution
    runs in the fleet step — on a throwaway ``streams``-wide state, an
    empty revolution in stream 0's first slot.  A warm-up tick of idle
    frames completes none, so an engine's precompile calls this: the first
    revolution in a steady-state loop then loads and resolves nothing."""
    st = create_fleet_ingest_state(cfg, streams, device=device)
    big_r, mn = cfg.max_revs, cfg.max_nodes
    nodes_all = torch.zeros((streams, big_r, mn, 4), dtype=_I32, device=device)
    lv = torch.zeros((streams, big_r, mn), dtype=torch.bool, device=device)
    counts = torch.zeros((streams, big_r), dtype=_I32, device=device)
    n_host = [1] + [0] * (streams - 1)
    n_completed = torch.tensor(n_host, dtype=_I32, device=device)
    out_wires = torch.zeros((streams, big_r, wire_output_len(cfg.filter)), dtype=_F32,
                            device=device)
    filters = [_stream_filter(st.filter, s) for s in range(streams)]
    _revolution_slots(filters, nodes_all, lv, counts, n_completed, n_host, st, cfg, out_wires)


def unpack_fleet_ingest_result(res, cfg: FleetIngestConfig) -> list:
    """Host-side parse of one fleet step's result tensors: one
    :class:`IngestBatchResult` per stream.  Only the wire rows of completed
    revolutions are fetched."""
    meta, wires, rp, rpts, mw, nodes, nts = (
        None if a is None else _np(a) if i != 1 else a
        for i, a in enumerate(_split_result(res, cfg))
    )
    if meta.ndim != 2 or meta.shape[1] != ingest_meta_len(cfg):
        raise ValueError(
            f"fleet ingest meta of shape {meta.shape} does not match cfg "
            f"(expected (streams, {ingest_meta_len(cfg)}))"
        )
    wires = _live_wires(wires, meta[:, 0])
    return _parse_fleet_rows(meta, wires, nodes, nts, cfg, rp, rpts, mw)


def _parse_fleet_rows(meta, wires, nodes_all, ts_all, cfg, recon_all=None, rpts_all=None,
                      map_all=None):
    return [
        _parse_row(
            meta[i],
            wires[i] if wires is not None else None,
            nodes_all[i] if nodes_all is not None else None,
            ts_all[i] if ts_all is not None else None,
            cfg,
            recon_all[i] if recon_all is not None else None,
            rpts_all[i] if rpts_all is not None else None,
            map_all[i] if map_all is not None else None,
        )
        for i in range(meta.shape[0])
    ]


def unpack_super_fleet_ingest_result(res, cfg: FleetIngestConfig) -> list:
    """Host-side parse of one super-step's result tensors: a list over the
    T ticks of per-stream :class:`IngestBatchResult` lists."""
    meta, wires, rp, rpts, mw, nodes, nts = (
        None if a is None else _np(a) if i != 1 else a
        for i, a in enumerate(_split_result(res, cfg))
    )
    if meta.ndim != 3 or meta.shape[2] != ingest_meta_len(cfg):
        raise ValueError(
            f"super-tick ingest meta of shape {meta.shape} does not match "
            f"cfg (expected (T, streams, {ingest_meta_len(cfg)}))"
        )
    wires = _live_wires(wires, meta[:, :, 0])
    return [
        _parse_fleet_rows(
            meta[t],
            wires[t] if wires is not None else None,
            nodes[t] if nodes is not None else None,
            nts[t] if nts is not None else None,
            cfg,
            rp[t] if rp is not None else None,
            rpts[t] if rpts is not None else None,
            mw[t] if mw is not None else None,
        )
        for t in range(meta.shape[0])
    ]
