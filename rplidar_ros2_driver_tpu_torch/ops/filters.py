"""ScanFilterChain tensor ops — the streaming step of the filter chain and
its fused K-scan form for offline replay (:func:`compact_filter_scan`).

The PyTorch counterpart of the JAX package's ``ops/filters.py``, held to
it bit for bit (``points_xy`` to 2 ulp, see :func:`polar_to_cartesian`):

  * range/intensity clip        (folded into the resample key mask)
  * angular-grid resample       (scatter-min range image, B fixed beams)
  * rolling-window temporal median (lower median over a (W, B) device ring)
  * polar -> Cartesian          (for PointCloud output)
  * 2-D voxel occupancy         (scatter-add histogram, W-scan accumulation)

The rolling window and voxel accumulator are device-resident state
(:class:`FilterState`).  Where the JAX package threads the state through a
donating jitted program, this package updates the state tensors IN PLACE:
each step writes its ring row, hit grid, accumulator and cursor into the
tensors it was given (``index_copy_`` at the 0-d device cursor, so no
per-revolution host sync), and only the derived sorted window of the
incremental median is replaced by a fresh tensor.  The one device->host
copy per revolution is the flat output wire (:func:`_pack_output_wire`).

The temporal median's kernels are hand-written CUDA in ``csrc/``, wrapped
by ops/median_kernels.py: B1 (``pallas``) and B2 (``inc_pallas``) on the
streaming step, B3 (``pallas``) on the fused path.  The plain functions
here (:func:`temporal_median`, :func:`sorted_replace`,
:func:`sliding_median`) are their reference versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, ScanBatch

TWO_PI = 2.0 * math.pi
_INT_INF = 0x7FFFFFFF


@dataclasses.dataclass
class FilterState:
    """Device-resident rolling state for the filter chain.

    Steps update the tensors in place (see the module note); the fields
    themselves are only reassigned for ``median_sorted``."""

    range_window: torch.Tensor   # (W, B) float32, +inf = no return
    inten_window: torch.Tensor   # (W, B) float32
    hit_window: torch.Tensor     # (W, G, G) int32 per-scan voxel grids
    voxel_acc: torch.Tensor      # (G, G) int32 running sum over the window
    cursor: torch.Tensor         # int32 0-d ring write position
    filled: torch.Tensor         # int32 0-d number of scans pushed (saturates at W)
    # derived state for median_backend "inc*": the window's multiset kept
    # sorted ascending per beam (None for the other backends).  Always the
    # sorted view of range_window's multiset — maintained incrementally by
    # the step, recomputed wholesale on restore.
    median_sorted: Optional[torch.Tensor] = None  # (W, B) float32

    @staticmethod
    def shapes(window: int, beams: int, grid: int) -> dict[str, tuple[int, ...]]:
        """Tensor shapes of a state with this geometry — host-side, no
        allocation (used to validate checkpoints before touching
        devices).  The derived median_sorted is not part of the
        checkpoint surface, so it does not appear here."""
        return {
            "range_window": (window, beams),
            "inten_window": (window, beams),
            "hit_window": (window, grid, grid),
            "voxel_acc": (grid, grid),
            "cursor": (),
            "filled": (),
        }

    @classmethod
    def for_config(cls, cfg: "FilterConfig", *, device) -> "FilterState":
        """The one config -> fresh-state mapping: backends that carry
        derived state (median_backend "inc*" needs the sorted window)
        get it here, so call sites can't forget the coupling."""
        return cls.create(
            cfg.window, cfg.beams, cfg.grid,
            with_sorted=cfg.median_backend.startswith("inc"),
            device=device,
        )

    @staticmethod
    def create(
        window: int, beams: int, grid: int, with_sorted: bool = False, *, device
    ) -> "FilterState":
        f32, i32 = torch.float32, torch.int32
        return FilterState(
            range_window=torch.full((window, beams), math.inf, dtype=f32, device=device),
            inten_window=torch.zeros((window, beams), dtype=f32, device=device),
            hit_window=torch.zeros((window, grid, grid), dtype=i32, device=device),
            voxel_acc=torch.zeros((grid, grid), dtype=i32, device=device),
            cursor=torch.zeros((), dtype=i32, device=device),
            filled=torch.zeros((), dtype=i32, device=device),
            # an all-inf ring is trivially sorted
            median_sorted=(
                torch.full((window, beams), math.inf, dtype=f32, device=device)
                if with_sorted else None
            ),
        )

    @staticmethod
    def from_numpy(
        snap: dict, *, device, with_sorted: bool = False
    ) -> "FilterState":
        """State from the host snapshot dict — the exact dict the JAX
        package's ``ScanFilterChain.snapshot()`` returns (and
        :meth:`to_numpy` gives), so a window carries across the two
        packages.  A ``median_sorted`` key is ignored: the sorted window
        is recomputed from the ring when ``with_sorted``."""
        dtypes = {
            "range_window": np.float32, "inten_window": np.float32,
            "hit_window": np.int32, "voxel_acc": np.int32,
            "cursor": np.int32, "filled": np.int32,
        }
        core = {
            k: torch.from_numpy(np.array(snap[k], dtype=dt)).to(device)
            for k, dt in dtypes.items()
        }
        return FilterState(
            **core,
            median_sorted=(
                recompute_median_sorted(core["range_window"]) if with_sorted else None
            ),
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copy in the JAX package's snapshot format (derived
        median_sorted excluded)."""
        return {
            f.name: getattr(self, f.name).cpu().numpy()
            for f in dataclasses.fields(self)
            if f.name != "median_sorted"
        }

    def clone(self) -> "FilterState":
        return FilterState(**{
            f.name: (None if getattr(self, f.name) is None else getattr(self, f.name).clone())
            for f in dataclasses.fields(self)
        })

    def to(self, device) -> "FilterState":
        """The same state on ``device`` (a copy unless already there)."""
        return FilterState(**{
            f.name: (None if getattr(self, f.name) is None else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Static chain configuration (same fields and defaults as the JAX
    package's, so one config describes both)."""

    window: int = 16
    beams: int = 2048
    grid: int = 256
    cell_m: float = 0.25
    range_min_m: float = 0.15
    range_max_m: float = 40.0
    intensity_min: float = 0.0
    enable_clip: bool = True
    enable_median: bool = True
    enable_voxel: bool = True
    # "xla" = plain sort; "pallas" = the B1 selection kernel
    # (ops/median_kernels.temporal_median_kernel); "inc" = incremental
    # sliding median over a sorted-window carried state, O(W) per step,
    # lowered per device ("inc_pallas", the B2 sorted_replace kernel, on
    # CUDA; "inc_xla", the plain formulation, on the CPU — both pinnable).
    # inc* requires FilterState created with with_sorted=True.
    median_backend: str = "xla"
    # kept for config parity with the JAX package (its sharded step's
    # all-reduce); unused by the single-device step
    voxel_reduce: str = "psum"
    # per-scan streaming-step resampler: "scatter" (scatter_reduce amin)
    # or "dense" (tiled masked-min, grid_resample_batch with K=1)
    resample_backend: str = "scatter"
    # voxel accumulation: "scatter" (index_add_ histogram) or "matmul"
    # (one-hot float32 product — exact counts; voxel_hits_matmul)
    voxel_backend: str = "scatter"


@dataclasses.dataclass(frozen=True)
class FilterOutput:
    """One step's outputs (tensors on the step's device, or numpy arrays
    after :func:`unpack_output_wire`)."""

    ranges: torch.Tensor        # (B,) median-filtered (or raw gridded) ranges
    intensities: torch.Tensor   # (B,)
    points_xy: torch.Tensor     # (B, 2) Cartesian projection of `ranges`
    point_mask: torch.Tensor    # (B,) finite-range mask
    voxel: torch.Tensor         # (G, G) occupancy counts over the window


# ---------------------------------------------------------------------------
# individual ops
# ---------------------------------------------------------------------------


def _clip_ok(batch: ScanBatch, cfg: FilterConfig) -> torch.Tensor:
    """The ONE clip predicate (returns inside [range_min, range_max] and
    at/above intensity_min), shared by the standalone clip_filter and
    the resample-key path so the two cannot drift.  Python scalars
    promote to float32 here, as JAX's weak types do."""
    dist_m = batch.dist_q2.to(torch.float32) * (1.0 / 4000.0)
    return (
        (dist_m >= cfg.range_min_m)
        & (dist_m <= cfg.range_max_m)
        & (batch.quality.to(torch.float32) >= cfg.intensity_min)
    )


def clip_filter(batch: ScanBatch, cfg: FilterConfig) -> ScanBatch:
    """Drop returns outside [range_min, range_max] or below intensity_min
    (zero dist marks the drop; node slots stay).  The step folds the same
    predicate into the resample-key mask instead — bit-identical."""
    ok = batch.valid & (batch.dist_q2 != 0) & _clip_ok(batch, cfg)
    return dataclasses.replace(
        batch, dist_q2=torch.where(ok, batch.dist_q2, torch.zeros_like(batch.dist_q2))
    )


def _resample_keys(batch: ScanBatch, beams: int, cfg: Optional[FilterConfig] = None):
    """Shared beam-index + packed-value computation of the resamplers:
    beam = angular cell, packed = dist<<8 | quality (so the per-beam min
    picks the nearest return and carries its intensity), _INT_INF marks
    dropped/invalid points.  With ``cfg`` given and clip enabled, the
    clip predicate folds into the drop mask."""
    ok = batch.valid & (batch.dist_q2 != 0)
    if cfg is not None and cfg.enable_clip:
        ok = ok & _clip_ok(batch, cfg)
    beam = torch.div(batch.angle_q14 * beams, 65536, rounding_mode="floor")
    beam = beam.clamp(0, beams - 1)
    packed = (batch.dist_q2 << 8) | batch.quality.clamp(0, 255)
    packed = packed.masked_fill(~ok, _INT_INF)
    return beam, packed


def _grid_decode(grid: torch.Tensor):
    """Per-beam packed min -> (ranges, intensities) with +inf / 0 misses."""
    hit = grid != _INT_INF
    ranges = ((grid >> 8).to(torch.float32) * (1.0 / 4000.0)).masked_fill(~hit, math.inf)
    inten = (grid & 0xFF).to(torch.float32).masked_fill(~hit, 0.0)
    return ranges, inten


def _offset_rows(idx: torch.Tensor, stride: int) -> torch.Tensor:
    """Flat keys of a (..., P) batch of per-row indices: ``idx + row *
    stride`` for each row.  A single row (no batch dims) is returned as it
    is, so the streaming step's one scan costs no extra device operation."""
    lead = tuple(idx.shape[:-1])
    if not lead:
        return idx
    n = math.prod(lead)
    rows = torch.arange(0, n * stride, stride, dtype=idx.dtype, device=idx.device)
    return idx + rows.reshape(lead + (1,))


def _scatter_min(beam: torch.Tensor, packed: torch.Tensor, beams: int):
    """Per-beam packed min of (..., P) keys -> (..., B) ranges and
    intensities, every row in ONE scatter keyed by ``row * B + beam``.
    The min is order-independent, so the scatter is exact in any order
    and equals the JAX package's dense masked-min bit for bit."""
    lead = tuple(beam.shape[:-1])
    rows = math.prod(lead)
    grid = torch.full((rows * beams,), _INT_INF, dtype=torch.int32, device=packed.device)
    key = _offset_rows(beam, beams)
    grid.scatter_reduce_(0, key.reshape(-1).long(), packed.reshape(-1), reduce="amin",
                         include_self=True)
    return _grid_decode(grid.reshape(lead + (beams,)))


def grid_resample(batch: ScanBatch, beams: int, cfg: Optional[FilterConfig] = None):
    """Scatter-min a scan (or a (K, N) batch of scans) onto a fixed
    angular grid of ``beams`` cells.

    Returns (ranges (..., B), intensities (..., B)) with +inf where no
    return."""
    beam, packed = _resample_keys(batch, beams, cfg)
    return _scatter_min(beam, packed, beams)


def grid_resample_batch(beam: torch.Tensor, packed: torch.Tensor, beams: int, block: int = 256):
    """Per-beam min for a whole (K, P) batch of scans at once, as a dense
    masked reduction tiled over beam blocks: out[k, b] = min over p of
    where(beam[k, p] == b, packed[k, p], INF)."""
    outs = []
    inf = torch.full((), _INT_INF, dtype=torch.int32, device=packed.device)
    for t0 in range(0, beams, block):
        bt = torch.arange(t0, min(t0 + block, beams), dtype=torch.int32, device=packed.device)
        m = torch.where(beam[:, None, :] == bt[None, :, None], packed[:, None, :], inf)
        outs.append(m.amin(dim=2))
    return _grid_decode(torch.cat(outs, dim=1))


def temporal_median(window: torch.Tensor) -> torch.Tensor:
    """Per-beam lower median over the (W, B) ring.

    +inf marks both missing returns and unfilled ring slots; they sort to
    the tail so the median is taken over actual returns only.  Beams with
    no return in the whole window stay +inf."""
    s = torch.sort(window, dim=0).values  # inf sorts last
    return median_from_sorted(s)


def sliding_median(ext: torch.Tensor, window: int) -> torch.Tensor:
    """K sliding per-beam lower medians over an extended history: ``ext``
    is (W + K, B), the previous ring in age order then K new rows; row i
    of the (K, B) result is the median of ``ext[i+1 : i+1+W]`` — what K
    successive :func:`temporal_median` calls on the advancing ring give.

    The unfold-and-sort form of the JAX package's XLA branch: the K
    windows are views of the stripe, sorted along the window axis."""
    k = ext.shape[0] - window
    windows = ext.unfold(0, window, 1)[1 : k + 1]  # (K, B, W)
    s = torch.sort(windows, dim=-1).values  # inf sorts last
    nvalid = torch.isfinite(windows).sum(dim=-1)
    pick = torch.div(nvalid - 1, 2, rounding_mode="floor").clamp(0, window - 1)
    med = torch.gather(s, -1, pick[..., None])[..., 0]
    return med.masked_fill(nvalid == 0, math.inf)


def sorted_replace(
    sorted_w: torch.Tensor, old_v: torch.Tensor, new_v: torch.Tensor
) -> torch.Tensor:
    """Multiset update of a per-beam sorted window: delete the FIRST
    occurrence of ``old_v``, insert ``new_v`` "after equals", keep it
    sorted — a 3-way select over {left-neighbor, self, right-neighbor}.

    Args: sorted_w (W, B) ascending per column; old_v (B,) MUST be
    present in each column (exact float equality — guaranteed when it
    came from the same ring); new_v (B,).  +inf entries participate like
    any value.  Returns (W, B)."""
    w = sorted_w.shape[0]
    iota = torch.arange(w, dtype=torch.int32, device=sorted_w.device)[:, None]
    # d: first slot holding old_v (argmax returns the first maximum)
    d = (sorted_w == old_v[None, :]).to(torch.int32).argmax(dim=0).to(torch.int32)
    # p: insertion index of new_v in the W-1 multiset without old_v
    p = (
        (sorted_w < new_v[None, :]).sum(dim=0, dtype=torch.int32)
        - (old_v < new_v).to(torch.int32)
    )
    left = torch.roll(sorted_w, 1, dims=0)    # left[i]  = s[i-1]
    right = torch.roll(sorted_w, -1, dims=0)  # right[i] = s[i+1]
    d_, p_ = d[None, :], p[None, :]
    shift_l = (d_ < p_) & (iota >= d_) & (iota < p_)
    shift_r = (d_ > p_) & (iota > p_) & (iota <= d_)
    out = torch.where(shift_l, right, torch.where(shift_r, left, sorted_w))
    return torch.where(iota == p_, new_v[None, :], out)


def pin_inc_lowering(median: str, platform: str) -> str:
    """The ONE device-type -> inc-lowering mapping ("inc_pallas", the B2
    sorted_replace kernel, on CUDA; "inc_xla", the plain formulation, on
    the CPU).  Non-"inc" values pass through."""
    if median != "inc":
        return median
    try:
        return {"cuda": "inc_pallas", "cpu": "inc_xla"}[platform]
    except KeyError:
        raise ValueError(f"no inc lowering for device type {platform!r}") from None


def inc_median(
    range_window: torch.Tensor,
    cursor: torch.Tensor,
    median_sorted: Optional[torch.Tensor],
    new_ranges: torch.Tensor,
    backend: str = "inc",
) -> tuple[torch.Tensor, torch.Tensor]:
    """One incremental-median step: evict the PRE-update ring row at
    ``cursor`` from the carried sorted window, insert ``new_ranges``,
    return (updated sorted window, median).  ``backend`` "inc" lowers per
    device (:func:`pin_inc_lowering`); "inc_xla" / "inc_pallas" pin one.
    ``range_window`` must not yet hold the new row."""
    if median_sorted is None:
        raise ValueError(
            "median_backend='inc' requires a state carrying the sorted "
            "window (FilterState.for_config provides it per config)"
        )
    old_v = range_window.index_select(0, cursor.view(1).long())[0]
    backend = pin_inc_lowering(backend, range_window.device.type)
    if backend == "inc_pallas":
        from rplidar_ros2_driver_tpu_torch.ops.median_kernels import sorted_replace_kernel

        return sorted_replace_kernel(median_sorted, old_v, new_ranges)
    ms = sorted_replace(median_sorted, old_v, new_ranges)
    return ms, median_from_sorted(ms)


def recompute_median_sorted(range_window: torch.Tensor) -> torch.Tensor:
    """Rebuild the derived sorted window from the ring — the ONE
    restore-time recompute (axis -2 covers (W, B) and (streams, W, B))."""
    return torch.sort(range_window, dim=-2).values


def median_from_sorted(sorted_w: torch.Tensor) -> torch.Tensor:
    """Per-beam lower median given the already-sorted (W, B) window —
    ``s[clip((nvalid-1)//2, 0, W-1)]``; all-inf beams stay +inf."""
    w = sorted_w.shape[0]
    nvalid = torch.isfinite(sorted_w).sum(dim=0)
    pick = torch.div(nvalid - 1, 2, rounding_mode="floor").clamp(0, w - 1)
    med = torch.gather(sorted_w, 0, pick[None, :])[0]
    return med.masked_fill(nvalid == 0, math.inf)


@functools.lru_cache(maxsize=16)
def _trig_table(beams: int, device: torch.device) -> torch.Tensor:
    """(B, 2) float32 [cos θ, sin θ] of the beam-centre angles, built once
    on the host per (beams, device).

    Trig is never evaluated on the device: f32 ``cos``/``sin`` differ by
    an ulp between PyTorch, JAX and CUDA's libdevice on a few percent of
    the angles, so a device evaluation would make the CPU and CUDA arms
    disagree.  θ is computed in float32 exactly as the JAX package does,
    ``(arange + 0.5) * f32(2π/B)``; cos/sin of that f32 value are taken
    in float64 and rounded to float32.  Both arms of this package read
    the same table (bit-identical); against JAX's own f32 trig the
    projection stays within 2 ulp."""
    theta = (np.arange(beams, dtype=np.float32) + np.float32(0.5)) * np.float32(TWO_PI / beams)
    t64 = theta.astype(np.float64)
    table = np.stack([np.cos(t64), np.sin(t64)], axis=-1).astype(np.float32)
    return torch.from_numpy(table).to(device)


@functools.lru_cache(maxsize=16)
def _f32_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: dividing by it is a true
    division on every device, where a Python-scalar divisor may become a
    multiplication by its (not correctly rounded) reciprocal."""
    return torch.full((), value, dtype=torch.float32, device=device)


def polar_to_cartesian(ranges: torch.Tensor, beams: int):
    """Beam-grid ranges (..., B) -> (..., B, 2) XY metres + finite mask."""
    finite = torch.isfinite(ranges)
    r = ranges.masked_fill(~finite, 0.0)
    xy = r[..., None] * _trig_table(beams, ranges.device)
    return xy, finite


def _voxel_cells(
    xy: torch.Tensor, mask: torch.Tensor, grid: int, cell_m: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gy, in_bounds) cell indices for one scan — the ONE place the
    grid-indexing convention (origin at the grid centre, floor
    semantics) lives, shared by both voxel ops.  xy is bounded by the
    masked polar projection, so the float->int cast stays in range."""
    half = grid // 2
    # graftlint: policed — xy comes from the masked polar projection
    # (non-finite ranges project to r=0) and is bounded by range_max_m,
    # so the cast never sees NaN/inf/out-of-int32 values
    ij = torch.floor(xy / _f32_scalar(cell_m, xy.device)).to(torch.int32) + half
    gx, gy = ij[..., 0], ij[..., 1]
    inb = mask & (gx >= 0) & (gx < grid) & (gy >= 0) & (gy < grid)
    return gx, gy, inb


def voxel_hits(xy: torch.Tensor, mask: torch.Tensor, grid: int, cell_m: float) -> torch.Tensor:
    """(..., G, G) occupancy counts, one grid per scan of ``xy`` (..., B, 2),
    origin at the grid centre.

    All scans go through ONE ``index_add_`` keyed by ``scan * G*G + cell``
    (``bincount`` would sync the host on CUDA to size its output).
    Out-of-grid points go to a spill cell that is cut off; integer atomics
    are order-independent, so the counts are exact."""
    gx, gy, inb = _voxel_cells(xy, mask, grid, cell_m)
    lead = tuple(gx.shape[:-1])
    cells = grid * grid
    scans = math.prod(lead)
    cell = _offset_rows(gx * grid + gy, cells)
    flat = torch.where(inb, cell, scans * cells)
    counts = torch.zeros((scans * cells + 1,), dtype=torch.int32, device=xy.device)
    counts.index_add_(0, flat.reshape(-1).long(), torch.ones_like(flat).reshape(-1))
    return counts[: scans * cells].reshape(lead + (grid, grid))


def voxel_hits_matmul(
    xy: torch.Tensor, mask: torch.Tensor, grid: int, cell_m: float
) -> torch.Tensor:
    """(..., G, G) occupancy counts via one-hot products (G, B) @ (B, G).

    Exact: the one-hots are 0/1, every product is exact, and float32
    accumulation is exact for counts below 2**24 (a scan contributes at
    most ``beams``).  Bit-identical to :func:`voxel_hits`."""
    gx, gy, inb = _voxel_cells(xy, mask, grid, cell_m)
    cells = torch.arange(grid, dtype=torch.int32, device=xy.device)
    # mask folded into one side only: a dead/out-of-grid point is all-zero
    ohx = ((gx[..., None] == cells) & inb[..., None]).to(torch.float32)
    ohy = (gy[..., None] == cells).to(torch.float32)
    # graftlint: disable=GL004 — the one sanctioned float accumulation:
    # 0/1 one-hot products are exact and the f32 accumulation is exact
    # for counts < 2^24, so order of reduction cannot matter
    # graftlint: policed — exact small integers in f32 (see above)
    return (ohx.transpose(-1, -2) @ ohy).to(torch.int32)


def select_voxel_hits(backend: str):
    """The one ``voxel_backend`` -> op mapping ("scatter" | "matmul").
    Strict: an unresolved "auto" or a typo fails loudly."""
    try:
        return {"scatter": voxel_hits, "matmul": voxel_hits_matmul}[backend]
    except KeyError:
        raise ValueError(
            f"voxel_backend must be 'scatter' or 'matmul' once resolved, "
            f"got {backend!r}"
        ) from None


# ---------------------------------------------------------------------------
# the chain step
# ---------------------------------------------------------------------------


def filter_step(
    state: FilterState, batch: ScanBatch, cfg: FilterConfig
) -> tuple[FilterState, FilterOutput]:
    """ScanBatch-level step (debug/parity API): updates ``state`` in
    place and returns it with an output whose tensors own their memory
    (the voxel grid is copied out of the accumulator)."""
    state, out = _filter_step_impl(state, batch, cfg)
    return state, dataclasses.replace(out, voxel=out.voxel.clone())


def _filter_step_impl(
    state: FilterState, batch: ScanBatch, cfg: FilterConfig
) -> tuple[FilterState, FilterOutput]:
    """One revolution through the full chain, updating ``state`` in place.

    clip (folded into the resample keys) -> grid resample -> ring update
    -> temporal median -> polar->Cartesian -> voxel accumulate
    (incremental: add the new scan's hit grid, retire the one falling out
    of the window).  The returned ``voxel`` IS the state's accumulator,
    which the next step mutates; the wire form copies it."""
    if cfg.resample_backend == "dense":
        beam, packed = _resample_keys(batch, cfg.beams, cfg)
        ranges, inten = grid_resample_batch(beam[None], packed[None], cfg.beams)
        ranges, inten = ranges[0], inten[0]
    elif cfg.resample_backend == "scatter":
        ranges, inten = grid_resample(batch, cfg.beams, cfg)
    else:
        raise ValueError(
            f"resample_backend must be 'scatter' or 'dense', got "
            f"{cfg.resample_backend!r}"
        )

    w = state.range_window.shape[0]
    cur = state.cursor.view(1).long()
    if cfg.enable_median and cfg.median_backend.startswith("inc"):
        # incremental sliding median: the ring evicts exactly ONE value
        # per step, so the sorted multiset is maintained by a delete +
        # insert; it reads the ring row BEFORE this step overwrites it
        state.median_sorted, med = inc_median(
            state.range_window, state.cursor, state.median_sorted, ranges,
            backend=cfg.median_backend,
        )
    state.range_window.index_copy_(0, cur, ranges[None])
    state.inten_window.index_copy_(0, cur, inten[None])
    if cfg.enable_median:
        if cfg.median_backend == "pallas":
            from rplidar_ros2_driver_tpu_torch.ops.median_kernels import temporal_median_kernel

            med = temporal_median_kernel(state.range_window)
        elif cfg.median_backend == "xla":
            med = temporal_median(state.range_window)
        elif not cfg.median_backend.startswith("inc"):
            raise ValueError(f"unknown median_backend {cfg.median_backend!r}")
    else:
        med = ranges
    xy, mask = polar_to_cartesian(med, cfg.beams)

    if cfg.enable_voxel:
        new_hits = select_voxel_hits(cfg.voxel_backend)(xy, mask, cfg.grid, cfg.cell_m)
        old_hits = state.hit_window.index_select(0, cur)[0]
        state.voxel_acc.add_(new_hits).sub_(old_hits)
        state.hit_window.index_copy_(0, cur, new_hits[None])

    state.filled.add_(1).clamp_(max=w)
    state.cursor.add_(1).remainder_(w)
    out = FilterOutput(
        ranges=med,
        intensities=inten,
        points_xy=xy,
        point_mask=mask,
        voxel=state.voxel_acc,
    )
    return state, out


# ---------------------------------------------------------------------------
# wire forms — one upload in, one fetch out per revolution
# ---------------------------------------------------------------------------


def _pack_compact_rows(buf, capacity: int, angle_q14, dist_q2, quality, flag) -> int:
    """Fill the leading columns of a (3, >=capacity) uint16 buffer with the
    bit-packed node stream (the JAX package's layout, byte for byte).
    Returns the node count.

    Layout (6 bytes/point): row0 = angle_q14; row1 = dist_q2 low 16;
    row2 = dist_q2 bits 17:16 | quality<<2 | flag<<10.  Distance is
    clamped to 18 bits (2^18 q2 = 65.5 m) and flag to 6 bits."""
    count = int(len(angle_q14))
    if count > capacity:
        raise ValueError(f"scan of {count} nodes exceeds capacity {capacity}")
    d = np.minimum(
        np.asarray(dist_q2, np.int64).astype(np.uint32), np.uint32(0x3FFFF)
    )
    buf[0, :count] = np.asarray(angle_q14, np.uint32).astype(np.uint16)
    buf[1, :count] = (d & 0xFFFF).astype(np.uint16)
    hi = (d >> 16).astype(np.uint16)
    hi |= ((np.asarray(quality, np.uint32) & 0xFF) << 2).astype(np.uint16)
    if flag is not None:
        hi |= ((np.asarray(flag, np.uint32) & 0x3F) << 10).astype(np.uint16)
    buf[2, :count] = hi
    return count


def pack_host_scan_counted(angle_q14, dist_q2, quality, flag=None, n: int | None = None):
    """Count-embedded wire form: a ``(3, n + 1)`` uint16 host buffer whose
    extra column's angle-row slot holds the node count, so one upload per
    revolution carries the scan and its count."""
    n = n or MAX_SCAN_NODES
    if n >= 0x10000:
        # the count slot is u16: a larger capacity would silently wrap
        raise ValueError(f"counted wire form supports capacity < 65536, got {n}")
    buf = np.zeros((3, n + 1), np.uint16)
    count = _pack_compact_rows(buf, n, angle_q14, dist_q2, quality, flag)
    buf[0, -1] = count
    return buf


def _unpack_compact(packed: torch.Tensor, count: torch.Tensor) -> ScanBatch:
    """Device-side inverse of the compact rows: a (3, N) scan with a 0-d
    count, or a (K, 3, N) sequence with (K,) counts (fields (K, N)).
    ``packed`` holds the uint16 wire bytes as int16 (PyTorch's
    full-featured 16-bit integer); ``& 0xFFFF`` after widening recovers
    the unsigned values."""
    p = packed.to(torch.int32) & 0xFFFF
    hi = p[..., 2, :]
    i = torch.arange(p.shape[-1], dtype=torch.int32, device=p.device)
    return ScanBatch(
        angle_q14=p[..., 0, :],
        dist_q2=p[..., 1, :] | ((hi & 0x3) << 16),
        quality=(hi >> 2) & 0xFF,
        flag=(hi >> 10) & 0x3F,
        valid=i < count[..., None],
        count=count,
    )


def wire_output_len(cfg: FilterConfig) -> int:
    return 5 * cfg.beams + cfg.grid * cfg.grid


def _pack_output_wire(out: FilterOutput) -> torch.Tensor:
    """The one definition of the flat wire layout — ``unpack_output_wire``
    and ``wire_output_len`` are its host-side inverses; keep all three in
    lockstep."""
    return torch.cat(
        [
            out.ranges,
            out.intensities,
            out.points_xy.reshape(-1),
            out.point_mask.to(torch.float32),
            out.voxel.reshape(-1).to(torch.float32),  # exact to 2^24 counts
        ]
    )


def counted_filter_step_wire(
    state: FilterState, packed: torch.Tensor, cfg: FilterConfig
) -> tuple[FilterState, torch.Tensor]:
    """The production step: the count-embedded ``(3, n + 1)`` wire buffer
    (uint16 bytes viewed as int16) in, the state updated in place, one
    flat float32 output vector out.  The count never leaves the device:
    it is read from the last column by the step itself."""
    count = packed[0, -1].to(torch.int32) & 0xFFFF
    state, out = _filter_step_impl(state, _unpack_compact(packed, count), cfg)
    return state, _pack_output_wire(out)


def pack_host_scan_compact(angle_q14, dist_q2, quality, flag=None, n: int | None = None):
    """Bit-packed wire form: ``(3, n)`` uint16, 6 bytes/point (row layout
    and clamps in :func:`_pack_compact_rows`), plus the node count."""
    n = n or MAX_SCAN_NODES
    buf = np.zeros((3, n), np.uint16)
    count = _pack_compact_rows(buf, n, angle_q14, dist_q2, quality, flag)
    return buf, count


def pack_host_scans_compact(scans, n: int | None = None):
    """Stack host scans (dicts of angle_q14/dist_q2/quality[/flag]) into
    the ``(K, 3, n)`` uint16 sequence buffer + ``(K,)`` int32 counts."""
    n = n or MAX_SCAN_NODES
    seq = np.zeros((len(scans), 3, n), np.uint16)
    counts = np.zeros((len(scans),), np.int32)
    for i, s in enumerate(scans):
        counts[i] = _pack_compact_rows(
            seq[i], n, s["angle_q14"], s["dist_q2"], s["quality"], s.get("flag")
        )
    return seq, counts


# -- fused multi-scan sequence step ------------------------------------------
#
# Offline/replay path: K scans advance the rolling window in one call of a
# few dozen device operations instead of K streaming steps.  It returns the
# per-scan median range images and the final state (whose voxel_acc is the
# window accumulation after the last scan); the full per-scan FilterOutput
# is not materialized.  None of the chain's dependencies is sequential:
#   * unpack/clip/resample are per-scan independent -> one scatter-min over
#     all K scans, keyed by k * B + beam;
#   * the window after step i is the W most recent rows of [previous ring
#     in age order] ++ [new rows], so every step's median is a sliding
#     window over one (W + K, B) stripe — kernel B3 (sliding_median_kernel)
#     for median_backend "pallas", else the plain sliding_median;
#   * the voxel accumulator after the last step is the sum of the final
#     window's per-scan hit grids (the streaming add-new/retire-old
#     telescopes).
# The ring is addressed by device-side index arithmetic on each cursor
# ((arange(W) + cursor) % W and its inverse), never a torch.roll by a
# Python int, so a chunk costs no host synchronisation.
#
# _compact_filter_scan_sequential is the semantic definition (exactly K
# streaming steps) that the fused path is parity-tested against.


def _compact_filter_scan_sequential(
    state: FilterState, packed_seq: torch.Tensor, counts: torch.Tensor, cfg: FilterConfig
) -> tuple[FilterState, torch.Tensor]:
    """Reference form: literally K successive streaming steps over the
    ``(K, 3, N)`` sequence (``state`` updated in place).  Returns (state,
    (K, B) ranges)."""
    ranges = []
    for i in range(packed_seq.shape[0]):
        state, out = _filter_step_impl(state, _unpack_compact(packed_seq[i], counts[i]), cfg)
        ranges.append(out.ranges)
    return state, torch.stack(ranges)


def _stripe(x: torch.Tensor) -> torch.Tensor:
    """A (..., R, B) plane laid out as one contiguous (R, S*B) stripe (S the
    product of the leading axes), so one median launch covers the fleet
    (the median kernels are per column and refuse strided inputs).  One
    stream's (R, B) plane is its own stripe: no copy."""
    r = x.shape[-2]
    return x.movedim(-2, 0).reshape(r, -1).contiguous()


def _unstripe(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Inverse of :func:`_stripe`: (R, S*B) -> (*lead, R, B)."""
    return x.reshape((x.shape[0],) + tuple(lead) + (-1,)).movedim(0, -2)


def fused_scan_core(
    state: FilterState,
    packed_seq: torch.Tensor,
    counts: torch.Tensor,
    cfg: FilterConfig,
    *,
    keys_fn,
    polar_fn,
    hits_fn,
) -> tuple[FilterState, torch.Tensor]:
    """The one fused K-scan formulation, over one stream's state or a
    stream-batched one (a leading S axis on every field and an (S,)
    cursor; ``packed_seq`` (S, K, 3, N), ``counts`` (S, K)).  Every step
    below is written over the leading axes, so the two are one code path;
    the sharded path injects the three partition-dependent primitives
    (every piece of boundary arithmetic lives only here):

    * ``keys_fn(batch) -> (beam, packed)`` — (..., K, N) resample keys;
    * ``polar_fn(rows) -> (xy, mask)`` — Cartesian projection of (..., m,
      B) range rows;
    * ``hits_fn(xy, mask) -> (..., m, G, G)`` — per-scan occupancy grids.

    The streams' history stripes are laid side by side, so the whole
    fleet's medians are ONE (W+K, S*B) sliding-median call.

    Updates ``state`` IN PLACE, like the streaming step: the ring, hit
    grids, accumulator, cursor and fill count are written into the
    tensors it holds; only the derived ``median_sorted`` is replaced (one
    re-sort per chunk).  Returns (state, (..., K, B) ranges).

    It is :func:`fused_scan_front` then :func:`fused_scan_back`: several
    beam blocks held in one process run every block's front half, sum
    their partial hit grids, then every block's back half."""
    front = fused_scan_front(state, packed_seq, counts, cfg, keys_fn=keys_fn,
                             polar_fn=polar_fn, hits_fn=hits_fn)
    return fused_scan_back(state, front, front.hits)


@dataclasses.dataclass
class ScanFront:
    """What the front half of a fused chunk hands its back half: the
    medians, the ring's age and ring index maps, the new cursor, the chunk
    length, and the surviving scans' hit grids (None without the voxel
    stage)."""

    med: torch.Tensor
    age: torch.Tensor
    ring: torch.Tensor
    cursor2: torch.Tensor
    k: int
    hits: Optional[torch.Tensor]


def fused_scan_front(state, packed_seq, counts, cfg: FilterConfig, *, keys_fn, polar_fn,
                     hits_fn) -> ScanFront:
    """Steps 1-4 of :func:`fused_scan_core` and the voxel stage's hit
    grids of the last min(K, W) scans (``hits_fn``'s output: partial on a
    beam block whose sum is left to the caller)."""
    k = packed_seq.shape[-3]
    w, b_local = state.range_window.shape[-2:]
    dev = state.range_window.device

    # 1. unpack + clip + resample every scan at once
    beam_k, packed_k = keys_fn(_unpack_compact(packed_seq, counts))  # (..., K, N) each
    new_r, new_i = _scatter_min(beam_k, packed_k, b_local)  # (..., K, B)

    # 2. extended history: previous ring in age order (oldest first), then
    # the new rows.  After step i the live window is ext[..., i+1 : i+1+W, :].
    # Rings are gathered along their window axis by per-stream row indices
    # (..., W, 1) that broadcast over the beams (and the grid's rows).
    iota_w = torch.arange(w, device=dev)
    age = torch.remainder(iota_w + state.cursor[..., None], w)[..., None]  # roll(ring, -cursor)
    ext_r = torch.cat([state.range_window.take_along_dim(age, dim=-2), new_r], dim=-2)

    # 3. every step's median in one pass over the history stripe
    if cfg.enable_median:
        if cfg.median_backend == "pallas":
            from rplidar_ros2_driver_tpu_torch.ops.median_kernels import (
                sliding_median_kernel as median_fn,
            )
        else:
            median_fn = sliding_median
        med = _unstripe(median_fn(_stripe(ext_r), w), ext_r.shape[:-2])
    else:
        med = new_r

    # 4. final window: the W most recent rows, back in ring layout
    # (ring = roll(age-ordered, +cursor'))
    cursor2 = torch.remainder(state.cursor + k, w).to(state.cursor.dtype)
    ring = torch.remainder(iota_w - cursor2[..., None], w)[..., None]
    ext_i = torch.cat([state.inten_window.take_along_dim(age, dim=-2), new_i], dim=-2)
    state.range_window.copy_(ext_r[..., k : k + w, :].take_along_dim(ring, dim=-2))
    state.inten_window.copy_(ext_i[..., k : k + w, :].take_along_dim(ring, dim=-2))

    # 5. voxel: the accumulator after the last step is the sum of the
    # final window's hit grids; only the last min(K, W) scans' grids
    # survive, so only those scans are projected
    hits = None
    if cfg.enable_voxel:
        m = min(k, w)
        hits = hits_fn(*polar_fn(med[..., k - m :, :]))  # (..., m, G, G)
    return ScanFront(med, age, ring, cursor2, k, hits)


def fused_scan_back(state: FilterState, front: ScanFront, new_hits: Optional[torch.Tensor]):
    """The rest of :func:`fused_scan_core` once the chunk's hit grids are
    whole (``new_hits``, None without the voxel stage): the hit ring, the
    accumulator, the cursor, the fill count and the sorted window.
    Returns (state, (..., K, B) ranges)."""
    k, age, ring = front.k, front.age, front.ring
    w = state.range_window.shape[-2]
    if new_hits is not None:
        if min(k, w) < w:
            # the W-K newest old grids
            kept = state.hit_window.take_along_dim(age[..., k:, :, None], dim=-3)
            ext_h = torch.cat([kept, new_hits], dim=-3)
        else:
            ext_h = new_hits
        state.hit_window.copy_(ext_h.take_along_dim(ring[..., None], dim=-3))
        state.voxel_acc.copy_(ext_h.sum(dim=-3, dtype=torch.int32))

    state.cursor.copy_(front.cursor2)
    state.filled.add_(k).clamp_(max=w)
    if state.median_sorted is not None:
        # K scans at once: the incremental backends' sorted window is
        # re-sorted wholesale to restore its invariant
        state.median_sorted = recompute_median_sorted(state.range_window)
    return state, front.med


def compact_filter_scan(
    state: FilterState, packed_seq: torch.Tensor, counts: torch.Tensor, cfg: FilterConfig
) -> tuple[FilterState, torch.Tensor]:
    """Run the chain over a ``(K, 3, N)`` packed scan sequence (uint16
    wire bytes as int16) with ``(K,)`` int32 counts, on their device.

    The same state trajectory as K successive streaming steps
    (:func:`_compact_filter_scan_sequential`; tests/test_torch_replay.py
    and chip_smoke.py hold the two equal).  ``state`` is updated in place
    (see :func:`fused_scan_core`).  Returns (state, (K, beams) ranges)."""
    return fused_scan_core(
        state, packed_seq, counts, cfg,
        keys_fn=lambda batch: _resample_keys(batch, cfg.beams, cfg),
        polar_fn=lambda rows: polar_to_cartesian(rows, cfg.beams),
        hits_fn=lambda xy, mask: select_voxel_hits(cfg.voxel_backend)(
            xy, mask, cfg.grid, cfg.cell_m
        ),
    )


def unpack_output_wire(wire, cfg: FilterConfig) -> FilterOutput:
    """Host-side inverse of the wire packing (numpy in, numpy out).

    Slices are copied: a view would pin the whole wire vector (and, for a
    pinned staging buffer, let the next revolution overwrite it)."""
    b, g = cfg.beams, cfg.grid
    w = np.asarray(wire)
    if w.size != wire_output_len(cfg):
        raise ValueError(
            f"wire vector of {w.size} floats does not match cfg "
            f"(expected {wire_output_len(cfg)})"
        )
    return FilterOutput(
        ranges=w[:b].copy(),
        intensities=w[b : 2 * b].copy(),
        points_xy=w[2 * b : 4 * b].reshape(b, 2).copy(),
        point_mask=w[4 * b : 5 * b] != 0.0,
        voxel=w[5 * b :].reshape(g, g).astype(np.int32),
    )
