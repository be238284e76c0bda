"""Loop closure on the device: submap library + batched candidate matching.

The PyTorch counterpart of the JAX package's ``ops/loop_close.py``.  Every
``submap_revs`` revolutions a stream's map is FINALIZED on the host
(mapping/submap.py) into a quantized submap plane (``clip(log_odds, 0,
clamp) >> quant_shift``, the matcher's own match-map form) and stored with
its anchor pose in a per-stream library (:class:`LoopState`).  A closure
check matches the current scan against the Kc nearest submaps of every
stream, applies three integer gates, appends an accepted match as a
pose-graph constraint and relaxes the graph (ops/pose_graph.py).

One check of S streams gathers the S·Kc candidate planes into one (S·Kc,
G, G) tensor and calls the matcher's score-volume core once
(ops/scan_match.match_scan_volumes): on ``match_backend="pallas"`` that is
one launch of B6 and one of B7 for the whole fleet, whatever S.

Acceptance gates (all integer):

  * overlap   — ``n_valid >= min_points`` quantized endpoints entered;
  * absolute  — ``best >= n_valid * accept_q`` (``accept_q * beams <
    2^31`` is validated, so the product is safe);
  * contrast  — ``best - min(volume) >= best >> peak_shift``: a saturated
    or featureless submap scores flat across the whole (dθ, dx, dy)
    volume, so peak-minus-floor contrast rejects it.

An accepted match becomes a constraint between the newest submap anchor
and the matched one (the transient current pose is eliminated through the
local odometry leg, so the graph lives over the fixed submap node set).
Everything is int32 in the matcher's Q format, so the NumPy twin
(ops/loop_close_ref.py) and the JAX package's fused program are bit-exact
against this one.  A stream whose check flag is 0 passes through: its
library is untouched and its wire row is to be ignored.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.ops.pose_graph import (
    PoseGraphConfig,
    device_table,
    fleet_solve_pose_graph,
    pose_compose,
    pose_relative,
    rel_inverse,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    MapConfig,
    match_scan_volumes,
    quantize_points,
)

LOOP_STATE_VERSION = 1
ODOM_WEIGHT = 1                # odometry-chain constraint weight
WIRE_LEN = 9                   # per-stream closure-check wire row length
INT32_MIN1 = -(2**31) + 1      # the score of an invalid candidate

STATE_KEYS = ("planes", "anchors", "odom", "valid", "count", "cons", "ncons", "dropped")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Static loop-closure configuration (the JAX package's, field for
    field).  ``match`` is the DERIVED candidate-match MapConfig
    (:func:`derive_match_config`); ``graph`` sizes the solver's planes."""

    match: MapConfig
    graph: PoseGraphConfig
    submap_revs: int = 8       # revolutions between submap finalizations
    max_submaps: int = 8       # library capacity (= pose-graph nodes)
    check_revs: int = 4        # revolutions between closure checks
    candidates: int = 2        # K nearest submaps scored per check
    max_constraints: int = 16  # loop-constraint plane capacity
    exclude_recent: int = 1    # newest submaps never offered as candidates
    min_points: int = 32       # overlap gate: quantized endpoints required
    accept_q: int = 60000      # absolute gate: per-point score bar
    peak_shift: int = 3        # contrast gate: best-minus-floor >= best>>s
    weight: int = 4            # loop-constraint weight (odometry is 1)
    reanchor: bool = False     # rewrite anchors/front-end pose on accept

    def __post_init__(self):
        if self.submap_revs < 1:
            raise ValueError("submap_revs must be >= 1")
        if self.max_submaps < 2:
            raise ValueError(
                "loop closure needs >= 2 submap slots (one to close "
                "against, one to close from)"
            )
        if self.check_revs < 1:
            raise ValueError("check_revs must be >= 1")
        if not (1 <= self.candidates <= self.max_submaps):
            raise ValueError("candidates must be within [1, max_submaps]")
        if self.exclude_recent < 1:
            raise ValueError(
                "exclude_recent must be >= 1 (a scan always matches the "
                "submap it was just absorbed into)"
            )
        if self.min_points < 1:
            raise ValueError("min_points must be >= 1")
        if self.accept_q < 1:
            raise ValueError("accept_q must be positive")
        # absolute-gate overflow bound: n_valid * accept_q in int32
        if self.accept_q * self.match.beams >= 2**31:
            raise ValueError(
                "accept gate can overflow int32: accept_q * beams "
                f"({self.accept_q} * {self.match.beams}) >= 2^31"
            )
        if not (0 <= self.peak_shift <= 30):
            raise ValueError("peak_shift must be within [0, 30]")
        if not (1 <= self.weight <= self.graph.weight_max):
            raise ValueError("loop weight must be within [1, graph.weight_max]")
        if self.max_constraints < 1:
            raise ValueError("max_constraints must be >= 1")
        if self.graph.max_nodes != self.max_submaps:
            raise ValueError(
                "pose-graph nodes must equal the submap capacity (the "
                "graph lives over the submap anchor set)"
            )
        if self.graph.max_constraints != self.max_submaps + self.max_constraints:
            raise ValueError(
                "graph.max_constraints must equal max_submaps + "
                "max_constraints (odometry chain rows + loop rows form "
                "one dense solver plane)"
            )
        if self.graph.theta_divisions != self.match.theta_divisions:
            raise ValueError("solver and matcher must share one rotation table")


def derive_match_config(map_cfg: MapConfig, *, theta_window: int, window_cells: int) -> MapConfig:
    """The one base-map -> candidate-match MapConfig derivation: submap
    planes are stored ALREADY quantized, so the candidate config sets
    ``quant_shift=0`` with the clamp at the stored ceiling (the score
    kernels' in-kernel quantization becomes the identity and the int32
    score bound holds with the same margin); ``hit_q``/``miss_q`` are
    pinned to the minimal legal pair (unused by scoring, but MapConfig
    validates clamp >= hit); the wider θ/translation windows are the
    loop-closure search radii."""
    return dataclasses.replace(
        map_cfg,
        clamp_q=max(map_cfg.clamp_q >> map_cfg.quant_shift, 1),
        quant_shift=0,
        hit_q=1,
        miss_q=-1,
        theta_window=theta_window,
        window_cells=window_cells,
    )


@dataclasses.dataclass
class LoopState:
    """Per-stream loop-closure state of S streams on one device, updated
    in place (like ``MapState``).  Dense padded planes throughout."""

    planes: torch.Tensor   # (S, K, G, G) int32 quantized submap match planes
    anchors: torch.Tensor  # (S, K, 3) int32 anchor poses (tx_sub, ty_sub, θ_idx)
    odom: torch.Tensor     # (S, K, 3) int32 measured prev-anchor -> anchor
    valid: torch.Tensor    # (S, K) int32 0/1 slot occupancy
    count: torch.Tensor    # (S,) int32 submaps finalized
    cons: torch.Tensor     # (S, C, 6) int32 loop constraints [i,j,zx,zy,zθ,w]
    ncons: torch.Tensor    # (S,) int32 appended loop constraints
    dropped: torch.Tensor  # (S,) int32 accepts dropped at the C cap

    @staticmethod
    def shapes(cfg: LoopConfig) -> dict[str, tuple[int, ...]]:
        """One stream's array shapes (host-side, no allocation) — the JAX
        package's ``LoopState.shapes``."""
        k, g, c = cfg.max_submaps, cfg.match.grid, cfg.max_constraints
        return {"planes": (k, g, g), "anchors": (k, 3), "odom": (k, 3), "valid": (k,),
                "count": (), "cons": (c, 6), "ncons": (), "dropped": ()}

    @classmethod
    def create(cls, cfg: LoopConfig, streams: int = 1, device="cpu") -> "LoopState":
        return cls(**{k: torch.zeros((streams, *v), dtype=torch.int32, device=device)
                      for k, v in cls.shapes(cfg).items()})

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "LoopState":
        """A state from a snapshot dict of stream-stacked numpy arrays
        (either package's ``LoopClosureEngine.snapshot()`` layout)."""
        return cls(**{k: torch.from_numpy(np.array(arrays[k], dtype=np.int32)).to(device)
                      for k in STATE_KEYS})

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field (fresh arrays, never views)."""
        return {k: getattr(self, k).cpu().numpy().copy() for k in STATE_KEYS}


# ---------------------------------------------------------------------------
# submap install (the quantize itself is host-side, mapping/submap.py)
# ---------------------------------------------------------------------------


def fleet_install_submap(states: LoopState, i: int, plane: torch.Tensor, anchor: torch.Tensor,
                         cfg: LoopConfig) -> LoopState:
    """Install one finalized submap of stream ``i`` into its next free slot,
    in place: plane + anchor stored, the odometry leg from the previous
    anchor recorded (slot 0 records identity — node 0 is the gauge
    anchor).  A full library freezes (cap-and-hold: the graph's node
    indices stay stable for the constraints that reference them).  The
    slot is chosen on the device; nothing reads the count back."""
    k, div = cfg.max_submaps, cfg.match.theta_divisions
    table = device_table(div, states.count.device)
    cnt = states.count[i]
    room = cnt < k
    slot = cnt.clamp(0, k - 1).reshape(1).long()
    prev = states.anchors[i].index_select(0, (cnt - 1).clamp(0, k - 1).reshape(1).long())[0]
    leg = torch.where(cnt == 0, torch.zeros_like(prev), pose_relative(prev, anchor, table, div))
    one = torch.ones((), dtype=torch.int32, device=cnt.device)
    for arr, row in ((states.planes[i], plane), (states.anchors[i], anchor),
                     (states.odom[i], leg), (states.valid[i], one)):
        cur = arr.index_select(0, slot)[0]
        arr.index_copy_(0, slot, torch.where(room, row, cur)[None])
    states.count[i] += room.to(torch.int32)
    return states


# ---------------------------------------------------------------------------
# the closure check: batched candidate match -> gates -> constraint ->
# pose-graph relaxation
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[s, idx[s]] for each stream s: (S, K, ...) by (S,) -> (S, ...)."""
    return t[torch.arange(t.shape[0], device=t.device), idx.long()]


def fleet_loop_close_step(states: LoopState, points_xy, masks, poses, cand_idx, check,
                          cfg: LoopConfig):
    """One closure check of S streams.  ``points_xy`` (S, B, 2) float32,
    ``masks`` (S, B) bool, ``poses`` (S, 3) int32 front-end poses,
    ``cand_idx`` (S, Kc) int32 host-selected candidate slots (-1 = none),
    ``check`` (S,) int32 0/1 — a stream with 0 passes through.

    ``states`` is updated in place.  Returns ``(states, wire, corrected)``:
    the (S, WIRE_LEN) int32 wire rows [accept, best_slot, best_score,
    n_valid, cur_x, cur_y, cur_θ, ncons, dropped] (cur_* = the pose-graph-
    corrected current pose) and the (S, K, 3) corrected anchors."""
    m = cfg.match
    k, div, lim = cfg.max_submaps, m.theta_divisions, m.t_limit_sub
    s, kc = cand_idx.shape
    dev = poses.device
    table = device_table(div, dev)
    streams = torch.arange(s, device=dev)

    pq, ok = quantize_points(points_xy, masks, m)
    ok = ok & (check > 0)[:, None]
    n_valid = ok.sum(dim=1, dtype=torch.int32)

    # -- batched candidate matching: S·Kc planes, one call --------------------
    slots = cand_idx.clamp(0, k - 1)
    cvalid = (cand_idx >= 0) & (torch.gather(states.valid, 1, slots.long()) > 0)
    planes = states.planes[streams[:, None], slots.long()].reshape(s * kc, m.grid, m.grid)

    def per_candidate(t: torch.Tensor) -> torch.Tensor:
        # (S, ...) -> (S·Kc, ...), each stream's row once per candidate; a
        # copy (a reshape of the expanded view can keep a zero stride)
        return t[:, None].expand(s, kc, *t.shape[1:]).reshape(s * kc, *t.shape[1:]).contiguous()

    # named ranges for torch.profiler (a check's host time is the solver's
    # or the scoring's; chip_smoke.py's loop phase reads them)
    with torch.profiler.record_function("loop_close.score"):
        dposes, bests, minvs = match_scan_volumes(
            planes, per_candidate(poses), per_candidate(pq), per_candidate(ok), m)
    dposes, bests, minvs = dposes.reshape(s, kc, 3), bests.reshape(s, kc), minvs.reshape(s, kc)
    masked = torch.where(cvalid, bests, INT32_MIN1)
    kbest = torch.argmax(masked, dim=1)                         # first-max-wins
    best = _rows(masked, kbest)
    dpose = _rows(dposes, kbest)
    minv = _rows(minvs, kbest)
    best_slot = _rows(slots, kbest)
    has_cand = cvalid.any(dim=1)

    # -- acceptance gates ------------------------------------------------------
    accept = (
        (check > 0) & has_cand & (n_valid >= cfg.min_points) & (best > 0)
        & (best >= n_valid * cfg.accept_q)
        & ((best - minv) >= (best >> cfg.peak_shift))
    )

    # -- constraint emission: eliminate the transient current pose -------------
    p_m = torch.stack([
        (poses[:, 0] + dpose[:, 0]).clamp(-lim, lim),
        (poses[:, 1] + dpose[:, 1]).clamp(-lim, lim),
        torch.remainder(poses[:, 2] + dpose[:, 2], div),
    ], dim=1)
    last = (states.count - 1).clamp(0, k - 1)
    a_last = _rows(states.anchors, last)
    a_best = _rows(states.anchors, best_slot)
    o_cur = pose_relative(a_last, poses, table, div)            # odometry leg
    z_jc = pose_relative(a_best, p_m, table, div)               # measured leg
    z_ij = pose_compose(o_cur, rel_inverse(z_jc, table, div), table, div)
    room = states.ncons < cfg.max_constraints
    do_append = accept & room
    row = torch.cat([last[:, None], best_slot[:, None], z_ij,
                     torch.full((s, 1), cfg.weight, dtype=torch.int32, device=dev)], dim=1)
    at = torch.arange(cfg.max_constraints, device=dev)[None, :] == (
        states.ncons.clamp(0, cfg.max_constraints - 1)[:, None])
    states.cons.copy_(torch.where((do_append[:, None] & at)[..., None], row[:, None, :],
                                  states.cons))
    states.ncons.add_(do_append.to(torch.int32))
    states.dropped.add_((accept & ~room).to(torch.int32))

    # -- pose-graph relaxation -------------------------------------------------
    ks = torch.arange(k, dtype=torch.int32, device=dev)
    odom_w = ((ks >= 1) & (ks < states.count[:, None])).to(torch.int32) * ODOM_WEIGHT
    odom_rows = torch.stack([
        (ks - 1).clamp_min(0).expand(s, k), ks.expand(s, k),
        states.odom[..., 0], states.odom[..., 1], states.odom[..., 2], odom_w,
    ], dim=2)                                                   # (S, K, 6)
    with torch.profiler.record_function("loop_close.solve"):
        corrected = fleet_solve_pose_graph(
            states.anchors, torch.cat([odom_rows, states.cons], dim=1), cfg.graph)

    # corrected CURRENT pose: the local odometry leg hung off the corrected
    # newest anchor (the front-end pose when the library is empty)
    cur_c = pose_compose(_rows(corrected, last), o_cur, table, div)
    cur_c = torch.stack([cur_c[:, 0].clamp(-lim, lim), cur_c[:, 1].clamp(-lim, lim),
                         cur_c[:, 2]], dim=1)
    cur_c = torch.where((states.count > 0)[:, None], cur_c, poses)

    if cfg.reanchor:
        # an accepted closure rewrites the stored anchors to the solution
        states.anchors.copy_(torch.where(accept[:, None, None], corrected, states.anchors))

    wire = torch.cat([
        accept.to(torch.int32)[:, None],
        torch.where(has_cand, best_slot, -1)[:, None],
        torch.where(has_cand, best.clamp_min(0), 0)[:, None],
        n_valid[:, None],
        cur_c,
        states.ncons[:, None],
        states.dropped[:, None],
    ], dim=1).to(torch.int32)
    return states, wire, corrected


def loop_close_step(state: LoopState, points_xy, mask, pose, cand_idx, check, cfg: LoopConfig):
    """Single-stream check: ``state`` holds one stream, ``points_xy`` is
    (B, 2), ``mask`` (B,), ``pose`` (3,), ``cand_idx`` (Kc,); returns the
    state, the (WIRE_LEN,) wire row and the (K, 3) corrected anchors."""
    dev = state.count.device
    check_t = torch.as_tensor(check, dtype=torch.int32, device=dev).reshape(1)
    state, wire, corrected = fleet_loop_close_step(
        state, points_xy[None], mask[None], pose[None], cand_idx[None], check_t, cfg)
    return state, wire[0], corrected[0]
