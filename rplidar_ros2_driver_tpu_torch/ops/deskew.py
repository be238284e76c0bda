"""Fixed-point range-only de-skew + caching-aware sweep reconstruction.

The PyTorch counterpart of the JAX package's ``ops/deskew.py``, held to it
bit for bit (``recon_points`` xy to 2 ulp, see ops/filters.
polar_to_cartesian).  Both stages ride inside the fused ingest core
(ops/ingest._segment_filter_core, behind ``deskew_enable``):

  1. **per-revolution range-only de-skew** — the rigid motion (dx, dy, dθ)
     between consecutive revolutions is estimated from their beam-gridded
     range profiles (a circular shift search for dθ, a diagonal
     least-squares radial fit for the translation), and every node is
     re-projected to the revolution's END pose by its phase fraction;
  2. **sweep reconstruction** — each tick's fresh nodes (de-skewed with
     the carried motion) are rasterized into a sub-sweep segment pushed
     into a ring of the last K segments; the newest-wins overlay of the
     ring is the reconstructed sweep emitted every tick.

Every function here works over any leading batch axes: the fused ingest
calls them once per tick for all streams (and all revolution slots), so
each kernel launch serves the whole tick.  The datapath is int32 end to
end (floor divisions, arithmetic shifts, explicit clamps), so the numpy
twin (ops/deskew_ref.py) and both backends are exact.  The only float
arithmetic is the clip predicate folded into the rasterizer (the chain's
own ``_clip_ok``) and the reconstructed sweep's polar decode.

``DeskewConfig.backend`` keeps the JAX package's names so one YAML drives
both packages: ``pallas`` routes the two dense loops through the CUDA
kernels B4/B5 (ops/deskew_kernels.py), ``xla`` through their plain
PyTorch versions.  ``auto`` resolves per device type
(:func:`resolve_deskew_backend`): the kernels on the card, the plain
versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    _INT_INF,
    _clip_ok,
    _grid_decode,
    polar_to_cartesian,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match import ANG_BITS, rotation_table

# empty-beam sentinel of the profiles and the sub-sweep ring: the chain's
# _INT_INF, because combine_ring's output feeds _grid_decode
RECON_EMPTY = _INT_INF

# rows of the matcher's int32 cos/sin table (2^14 scale) used for per-node
# trig: the wire angle indexes it with one shift (65536 / 1024 = 64)
TABLE_DIVISIONS = 1024

# packed sub-sweep cell layout (dist << 8 | quality), the resampler's
_QUAL_BITS = 8


@dataclasses.dataclass(frozen=True)
class DeskewConfig:
    """Static de-skew + reconstruction configuration (the JAX package's
    fields, defaults and checks)."""

    recon_beams: int          # sub-sweep/reconstruction beam grid (= chain beams)
    profile_beams: int = 256  # motion-profile beam grid (power of two)
    shift_window: int = 8     # dθ search: ± profile-beam shifts
    recon_window: int = 4     # K sub-sweep segments kept per stream
    max_trans_q2: int = 2048  # per-revolution translation clamp (q2 units)
    min_valid: int = 16       # min overlapping profile beams for an estimate
    # the chain's clip stage mirrored into the rasterizer (enable flag
    # included: without the clip stage the reconstruction keeps
    # out-of-range returns too)
    enable_clip: bool = True
    range_min_m: float = 0.15
    range_max_m: float = 40.0
    intensity_min: float = 0.0
    # "pallas" = kernels B4/B5, "xla" = their plain PyTorch versions;
    # exact either way (int32 min/sum are order-independent)
    backend: str = "xla"

    def __post_init__(self):
        if self.backend not in ("xla", "pallas"):
            raise ValueError(
                "deskew backend must be 'xla' or 'pallas' once resolved "
                "(the 'auto' spelling resolves in resolve_deskew_backend "
                "before DeskewConfig is built)"
            )
        d = self.profile_beams
        if d < 64 or d > 1024 or d & (d - 1):
            raise ValueError("deskew profile_beams must be a power of two in [64, 1024]")
        if TABLE_DIVISIONS % d:
            raise ValueError(
                f"deskew profile_beams must divide the trig table ({TABLE_DIVISIONS} rows)"
            )
        if not (1 <= self.shift_window <= d // 8):
            raise ValueError("deskew shift_window must be within [1, profile_beams/8]")
        if self.shift_window * (65536 // d) > (1 << 13):
            raise ValueError("deskew shift window exceeds the 2^13 dθ overflow bound")
        if not (2 <= self.recon_window <= 64):
            raise ValueError("sweep_reconstruct_window must be in [2, 64]")
        if not (8 <= self.recon_beams <= 8192):
            raise ValueError(
                "recon_beams must be in [8, 8192] (the reconstruction-sum bound)"
            )
        if not (0 < self.max_trans_q2 <= (1 << 11)):
            raise ValueError(
                "deskew max_trans_q2 must be in (0, 2^11] (the int32 "
                "normal-equation bound)"
            )
        if self.min_valid < 1:
            raise ValueError("deskew min_valid must be >= 1")


def resolve_deskew_backend(requested: str, platform: Optional[str] = None) -> str:
    """Resolve the ``auto`` de-skew lowering for a torch device type:
    ``pallas`` (kernels B4/B5) on CUDA, ``xla`` (the plain versions) on
    the CPU — a path on the card launches its kernels.  Explicit requests
    pass through."""
    if requested != "auto":
        return requested
    try:
        return {"cuda": "pallas", "cpu": "xla"}[platform]
    except KeyError:
        raise ValueError(
            f"no de-skew backend for device type {platform!r} (auto resolves "
            "per device: pass the torch device type)"
        ) from None


def deskew_config_from_params(
    params, beams: int, platform: Optional[str] = None
) -> Optional[DeskewConfig]:
    """The one params -> DeskewConfig mapping (None when disabled).  The
    clip fold mirrors the chain's clip params: the reconstructed sweep
    keeps exactly the returns the filter keeps."""
    if not getattr(params, "deskew_enable", False):
        return None
    return DeskewConfig(
        recon_beams=beams,
        profile_beams=int(getattr(params, "deskew_profile_beams", 256)),
        shift_window=int(getattr(params, "deskew_shift_window", 8)),
        recon_window=int(getattr(params, "sweep_reconstruct_window", 4)),
        enable_clip="clip" in tuple(params.filter_chain),
        range_min_m=float(params.range_clip_min_m),
        range_max_m=float(params.range_clip_max_m),
        intensity_min=float(params.intensity_min),
        backend=resolve_deskew_backend(getattr(params, "deskew_backend", "auto"), platform),
    )


def shift_candidates(cfg: DeskewConfig) -> np.ndarray:
    """(2S+1,) int32 dθ shift candidates ordered by |s| (0, -1, 1, ...):
    the first-min-wins argmin then prefers the SMALLEST rotation on ties,
    so a featureless scene estimates identity."""
    out = [0]
    for s in range(1, cfg.shift_window + 1):
        out.extend((-s, s))
    return np.asarray(out, np.int32)


def profile_trig(cfg: DeskewConfig) -> np.ndarray:
    """(D, 2) int32 cos/sin at 2^14 scale of each profile beam's start
    angle — rows of the matcher's rotation table, built on the host."""
    table = rotation_table(TABLE_DIVISIONS)
    return table[:: TABLE_DIVISIONS // cfg.profile_beams]


def node_trig_table() -> np.ndarray:
    """(TABLE_DIVISIONS, 2) int32 cos/sin for per-node de-skew trig,
    indexed by ``angle >> 6``."""
    return rotation_table(TABLE_DIVISIONS)


@functools.lru_cache(maxsize=32)
def _device_table(kind: str, profile_beams: int, device: torch.device) -> torch.Tensor:
    """The host-built int32 tables on ``device``, uploaded once."""
    table = rotation_table(TABLE_DIVISIONS)
    if kind == "profile":  # profile_trig's rows
        table = table[:: TABLE_DIVISIONS // profile_beams]
    return torch.from_numpy(np.ascontiguousarray(table)).to(device)


@functools.lru_cache(maxsize=32)
def _device_candidates(cfg: DeskewConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shift_candidates(cfg)).to(device)


def _beam_min(beam: torch.Tensor, values: torch.Tensor, nbeams: int, backend: str):
    """(..., n) int32 beams/values -> (..., nbeams) per-beam min over every
    row, through B4 (``pallas``) or its plain version (``xla``)."""
    lead = tuple(beam.shape[:-1])
    b2 = beam.reshape(-1, beam.shape[-1]).contiguous()
    v2 = values.reshape(-1, values.shape[-1]).contiguous()
    fn = dk.beam_min_kernel if backend == "pallas" else dk.beam_min_plain
    return fn(b2, v2, nbeams).reshape(lead + (nbeams,))


# ---------------------------------------------------------------------------
# fixed-point building blocks (literal mirrors in ops/deskew_ref.py)
# ---------------------------------------------------------------------------


def beam_of(angle: torch.Tensor, beams: int) -> torch.Tensor:
    """Wire angle -> beam cell, the chain resampler's exact convention."""
    return torch.div(angle * beams, 65536, rounding_mode="floor").clamp(0, beams - 1)


def profile_from_nodes(angle, dist, valid, cfg: DeskewConfig) -> torch.Tensor:
    """(..., D) int32 min-range beam profile of each row's nodes
    (RECON_EMPTY where no return): one per-beam min over every row, a dead
    node contributing the min identity."""
    d = cfg.profile_beams
    live = valid & (dist > 0)
    return _beam_min(beam_of(angle, d), dist.masked_fill(~live, RECON_EMPTY), d, cfg.backend)


def _gather_shifted(cur: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """``roll(cur, s)`` along the last axis by per-row device shifts, as a
    gather: out[..., d] = cur[..., (d - s) mod D] (no host value of s)."""
    d = cur.shape[-1]
    idx = torch.remainder(
        torch.arange(d, dtype=torch.int64, device=cur.device) - shifts[..., None].long(), d
    )
    return torch.gather(cur, -1, idx)


def estimate_motion(prev_prof, cur_prof, cfg: DeskewConfig) -> torch.Tensor:
    """(..., 3) int32 [dx_q2, dy_q2, dθ_q16] rigid-motion estimate between
    consecutive revolutions' range profiles (the JAX function's exact
    arithmetic).  dθ: the circular shift whose clamped mean-|Δ| over
    beams valid in both profiles is least (B5 scores every candidate),
    candidates in |s| order so ties prefer identity; (dx, dy): one
    diagonal least-squares radial fit per axis with the rotation taken
    out.  Fewer than ``min_valid`` overlapping beams estimates zero."""
    d = cfg.profile_beams
    mt = cfg.max_trans_q2
    dev = cur_prof.device
    lead = tuple(cur_prof.shape[:-1])
    prev2 = prev_prof.reshape(-1, d).contiguous()
    cur2 = cur_prof.reshape(-1, d).contiguous()
    cands = _device_candidates(cfg, dev)
    fn = dk.shift_sad_kernel if cfg.backend == "pallas" else dk.shift_sad_plain
    scores = fn(prev2, cur2, cands, cfg.min_valid, mt)            # (R, C)
    best = torch.argmin(scores, dim=-1)                         # first min wins
    s_best = cands[best]                                        # (R,)
    usable = scores.gather(-1, best[:, None])[:, 0] != RECON_EMPTY

    aligned = _gather_shifted(cur2, s_best)
    both = (prev2 != RECON_EMPTY) & (aligned != RECON_EMPTY)
    diff = torch.where(both, aligned - prev2, 0).clamp(-mt, mt)
    trig = _device_table("profile", d, dev)
    c7 = trig[:, 0] >> 7
    s7 = trig[:, 1] >> 7
    bi = both.to(torch.int32)
    i32 = torch.int32
    num_x = (diff * c7 * bi).sum(-1, dtype=i32)
    den_x = (c7 * c7 * bi).sum(-1, dtype=i32)
    num_y = (diff * s7 * bi).sum(-1, dtype=i32)
    den_y = (s7 * s7 * bi).sum(-1, dtype=i32)
    dx = -torch.div(num_x, (den_x >> 7).clamp(min=1), rounding_mode="floor")
    dy = -torch.div(num_y, (den_y >> 7).clamp(min=1), rounding_mode="floor")
    dth = (s_best * (65536 // d)).clamp(-(1 << 13), 1 << 13)
    motion = torch.stack([dx.clamp(-mt, mt), dy.clamp(-mt, mt), dth], -1).to(i32)
    motion = torch.where(usable[:, None], motion, 0)
    return motion.reshape(lead + (3,))


def apply_deskew(angle, dist, valid, motion, cfg: DeskewConfig):
    """Re-project nodes (..., n) to the revolution's END pose by their
    phase fraction with the (..., 3) motion of their row: a node at wire
    angle ``a`` still has ``(65536 - a)/65536`` of the motion ahead of it.
    Zero motion is the exact identity.  Returns (angle', dist') with
    dist' clamped into the 18-bit wire domain; dead and no-return nodes
    pass through untouched."""
    del cfg  # geometry-independent, kept for signature lockstep
    table = _device_table("node", 0, angle.device)
    m = motion[..., None, :]
    rem = 65536 - angle                                           # 1..65536
    dang = (rem * m[..., 2]) >> 16
    angle2 = (angle - dang) & 0xFFFF
    idx = (angle >> 6).long()
    c, s = table[idx, 0], table[idx, 1]
    half = 1 << (ANG_BITS - 1)
    radial = (m[..., 0] * c + m[..., 1] * s + half) >> ANG_BITS  # q2 units
    corr = (radial * rem) >> 16
    dist2 = (dist - corr).clamp(1, 0x3FFFF)
    live = valid & (dist > 0)
    return torch.where(live, angle2, angle), torch.where(live, dist2, dist)


def rasterize_subsweep(angle, dist, quality, valid, cfg: DeskewConfig) -> torch.Tensor:
    """(..., B) int32 packed sub-sweep segment of each row's (de-skewed)
    nodes: per-beam min of ``dist << 8 | quality`` (nearest return wins,
    carrying its intensity), RECON_EMPTY where untouched.  The chain's
    clip predicate (ops/filters._clip_ok, the same function) folds into
    the drop mask, so the reconstruction keeps exactly the returns the
    filter keeps."""
    ok = valid & (dist > 0)
    if cfg.enable_clip:
        batch = ScanBatch(angle_q14=angle, dist_q2=dist, quality=quality,
                          flag=torch.zeros_like(angle), valid=valid,
                          count=torch.zeros((), dtype=torch.int32))
        ok = ok & _clip_ok(batch, cfg)
    b = cfg.recon_beams
    packed = (dist << _QUAL_BITS) | quality.clamp(0, 255)
    return _beam_min(beam_of(angle, b), packed.masked_fill(~ok, RECON_EMPTY), b, cfg.backend)


def push_ring(ring, pos, seg, pushed):
    """Advance each stream's sub-sweep ring (..., K, B) by one segment
    (..., B) where ``pushed`` (an idle tick leaves ring and position
    untouched).  ``pos`` counts pushes; the write slot is ``pos % K``.
    Returns new tensors."""
    k = ring.shape[-2]
    slot = torch.remainder(pos, k).long()
    onehot = torch.arange(k, device=ring.device) == slot[..., None]      # (..., K)
    write = onehot & pushed[..., None]
    new_ring = torch.where(write[..., None], seg[..., None, :], ring)
    return new_ring, pos + pushed.to(pos.dtype)


def combine_ring(ring, pos) -> torch.Tensor:
    """(..., B) newest-wins overlay of each ring's segments: a beam keeps
    the most recent segment that touched it.  The age order (oldest
    first) is a gather at ``(i + pos % K) % K`` — the JAX ``roll`` by a
    device value, with no host read."""
    k = ring.shape[-2]
    order = torch.remainder(
        torch.arange(k, device=ring.device) + torch.remainder(pos, k)[..., None].long(), k
    )
    aged = torch.gather(ring, -2, order[..., None].expand(ring.shape))
    combined = torch.full(ring.shape[:-2] + ring.shape[-1:], RECON_EMPTY,
                          dtype=torch.int32, device=ring.device)
    for i in range(k):
        row = aged[..., i, :]
        combined = torch.where(row != RECON_EMPTY, row, combined)
    return combined


def recon_points(combined):
    """Reconstructed sweep (..., B) -> (ranges (..., B), xy (..., B, 2),
    mask (..., B)): the chain's own decode and polar projection."""
    ranges, _inten = _grid_decode(combined)
    xy, mask = polar_to_cartesian(ranges, combined.shape[-1])
    return ranges, xy, mask
