"""Per-stream submap lifecycle — the host half of the loop-closure
back-end (ops/loop_close.py holds the device half).  A copy of the JAX
package's ``mapping/submap.py`` with its imports pointed at this package.

Every ``loop_submap_revs`` revolutions a stream's live MapState is
FINALIZED: the log-odds grid quantizes into the exact match-map form
the matcher's score engines consume (``clip(·, 0, clamp_q) >>
quant_shift`` — ops/scan_match.match_coarse_scores applies the same
transform in-kernel, so a stored plane with ``quant_shift=0`` scores
identically to a live map), and the pose at finalization becomes the
submap's anchor — a pose-graph node.  The quantization runs HERE, in
numpy, for both loop backends: one finalization path means backend
choice cannot change what lands in the library.

Candidate selection is also host-side and integer-deterministic (stable
argsort over L1 anchor distances), again shared by both backends — the
dispatch only ever sees the selected slot list, so the device and numpy
arms cannot diverge on WHICH submaps they score.
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.loop_close import LoopConfig
from rplidar_ros2_driver_tpu_torch.ops.scan_match import MapConfig


def quantize_submap_plane(log_odds, cfg: MapConfig) -> np.ndarray:
    """Finalize a log-odds grid into its stored submap match plane —
    the matcher's quantized form, materialized once at finalization
    instead of per score dispatch.  Pure integer (int32 in, int32
    out), so it is its own reference."""
    lo = np.asarray(log_odds, np.int32)
    return (np.clip(lo, 0, cfg.clamp_q) >> cfg.quant_shift).astype(np.int32)


def finalize_due(revision: int, cfg: LoopConfig) -> bool:
    """Is a submap finalization due at this revolution count?"""
    return revision > 0 and revision % cfg.submap_revs == 0


def check_due(revision: int, cfg: LoopConfig) -> bool:
    """Is a loop-closure check due at this revolution count?"""
    return revision > 0 and revision % cfg.check_revs == 0


def eligible_candidates(valid, count: int, cfg: LoopConfig) -> np.ndarray:
    """Boolean (K,) eligibility: occupied slots old enough to offer —
    the newest ``exclude_recent`` submaps are never candidates (the
    current scan was just absorbed into them; a self-match carries no
    loop information)."""
    k = cfg.max_submaps
    ages = np.arange(k)
    return (np.asarray(valid) > 0) & (ages < count - cfg.exclude_recent)


def select_candidates(
    anchors, valid, count: int, pose_q, cfg: LoopConfig
) -> np.ndarray:
    """The (candidates,) int32 slot list for one closure check: the K
    nearest eligible submaps by L1 anchor distance to the current pose,
    stable-sorted (deterministic ties by slot order), padded with -1.
    Distances accumulate in int64 — two subcell coordinates can sum
    past int32 at the largest permitted grids."""
    kc = cfg.candidates
    elig = eligible_candidates(valid, count, cfg)
    if not elig.any():
        return np.full((kc,), -1, np.int32)
    a = np.asarray(anchors, np.int64)
    p = np.asarray(pose_q, np.int64)
    dist = np.abs(a[:, 0] - p[0]) + np.abs(a[:, 1] - p[1])
    dist = np.where(elig, dist, np.iinfo(np.int64).max)
    order = np.argsort(dist, kind="stable")[:kc]
    sel = np.where(elig[order], order, -1).astype(np.int32)
    out = np.full((kc,), -1, np.int32)
    out[: len(sel)] = sel
    return out
