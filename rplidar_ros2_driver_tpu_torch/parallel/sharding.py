"""SPMD scale-out of the filter chain over a ``(stream, beam)`` device mesh.

The PyTorch counterpart of the JAX package's ``parallel/sharding.py``:

  * **stream parallelism** (the data-parallel axis): many lidar units,
    each with its own rolling window/voxel state, on mesh axis
    ``"stream"``;
  * **beam parallelism** (the sequence-parallel axis): the fixed angular
    grid of B beams is split across mesh axis ``"beam"``.  The temporal
    median is beam-local (the window axis is whole on every shard); the
    voxel accumulation is a partial sum per shard, reduced over the beam
    axis — one all-reduce per step (or per fused chunk).

**One device per process.**  JAX runs one controller over many devices
and its ``shard_map`` program holds every shard.  PyTorch's SPMD idiom is
one process per device, so here a :class:`Mesh` is this process's view:
the axis extents, its own device and coordinates, and — across processes
— a ``torch.distributed`` ``DeviceMesh`` whose ``"beam"`` group carries
the voxel all-reduce.  Every function below works on the LOCAL block: the
process at mesh coordinates ``(i, j)`` holds streams ``[i*S/s,
(i+1)*S/s)`` and beams ``[j*B/b, (j+1)*B/b)``.  In one process (no process
group) the mesh is ``(1, 1)`` and the local block is the whole fleet.

The local streams are batched, never looped: one step is one median
launch for the whole block (B1, or B2 for ``inc``), its rings laid side
by side as one ``(W, S_local*b_local)`` stripe, and one fused chunk is one
B3 launch over the ``(W+K, S_local*b_local)`` history stripe.

The all-reduce is ``psum`` (``dist.all_reduce(SUM)``) or an explicit
``ring`` of N-1 ``batch_isend_irecv`` hops (``FilterConfig.voxel_reduce``);
int32 adds are exact in any order, so the two are bit-equal.  On a gloo
group the ring stages each hop of a CUDA tensor through pinned host
tensors — explicitly, only in that mode, counted in ``ring_host_hops`` —
since gloo's point-to-point ops are host-memory transports (its
all-reduce takes CUDA tensors).  NCCL refuses two ranks on one device;
two processes sharing one card use gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    FilterConfig,
    FilterOutput,
    FilterState,
    _clip_ok,
    _scatter_min,
    _stripe,
    _trig_table,
    _unstripe,
    fused_scan_core,
    median_from_sorted,
    pin_inc_lowering,
    select_voxel_hits,
    sorted_replace,
    temporal_median,
)

_INT_INF = 0x7FFFFFFF

# ring hops of a CUDA tensor staged through host memory (gloo groups)
ring_host_hops = 0


def _default_device() -> torch.device:
    """The card of this process: ``cuda:(rank % cards)`` in a process
    group, ``cuda:0`` alone; raises without CUDA (never a silent host
    fallback — pass ``device="cpu"`` to run on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh needs a CUDA device and none is available; pass "
            "device='cpu' to run the mesh on the host"
        )
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """This process's view of a ``(stream, beam)`` mesh: the axis extents
    (``shape``), its device, its ``coords`` on the mesh and, when the mesh
    spans processes, the ``DeviceMesh`` that holds the per-axis groups."""

    def __init__(self, stream: int, beam: int, device, *, coords=(0, 0),
                 device_mesh=None) -> None:
        self.shape = {"stream": int(stream), "beam": int(beam)}
        self.device = torch.device(device)
        self.coords = tuple(int(c) for c in coords)
        self.device_mesh = device_mesh

    @property
    def spans_processes(self) -> bool:
        return self.device_mesh is not None

    @property
    def beam_group(self):
        """The process group of this process's beam row (None when the
        beam axis has extent 1: the all-reduce is the identity)."""
        if self.device_mesh is None or self.shape["beam"] == 1:
            return None
        return self.device_mesh["beam"].get_group()

    def local_streams(self, streams: int) -> slice:
        """The stream rows this process holds."""
        s = self.shape["stream"]
        if streams % s:
            raise ValueError(f"streams={streams} not divisible by stream axis {s}")
        per = streams // s
        return slice(self.coords[0] * per, (self.coords[0] + 1) * per)

    def local_beams(self, beams: int) -> slice:
        """The beam columns this process holds."""
        b_local = _beams_per_shard(self, beams)
        return slice(self.coords[1] * b_local, (self.coords[1] + 1) * b_local)

    def __repr__(self) -> str:
        return (f"Mesh(stream={self.shape['stream']}, beam={self.shape['beam']}, "
                f"device={self.device}, coords={self.coords})")


def make_mesh(
    n_devices: Optional[int] = None,
    stream: Optional[int] = None,
    device=None,
) -> Mesh:
    """Build a 2-D ``(stream, beam)`` mesh.  ``stream`` fixes the
    data-parallel extent; the beam axis takes the rest (default: the
    squarest split with stream <= beam, as in the JAX package).

    Without a process group there is one device: ``n_devices`` 1 (the
    default) gives the ``(1, 1)`` mesh on ``device`` (default: the card).
    In a process group, ``n_devices`` defaults to the world size and the
    mesh spans every process (one device each); ``n_devices=1`` gives
    this process a mesh of its own.  More devices than processes raise."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, only {world} available")
    if n_devices not in (1, world):
        raise ValueError(
            f"a mesh spans one device or every process of the group "
            f"({world}), not {n_devices}"
        )
    if stream is None:
        stream = 1
        for s in range(int(np.sqrt(n_devices)), 0, -1):
            if n_devices % s == 0:
                stream = s
                break
    if n_devices % stream:
        raise ValueError(f"stream={stream} does not divide {n_devices} devices")
    beam = n_devices // stream
    device = torch.device(device) if device is not None else _default_device()
    if n_devices == 1:
        return Mesh(1, 1, device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (stream, beam), mesh_dim_names=("stream", "beam"))
    return Mesh(stream, beam, device, coords=tuple(dm.get_coordinate()), device_mesh=dm)


def shard_card(shard: int, cards: int) -> int:
    """The card of serving-pod shard ``shard`` over ``cards`` cards: one
    shard a card, round-robin, ``shard % cards`` (one card: every shard on
    it).  With ``cards <= shards`` this is the first device of the JAX
    pod's group for the shard (its groups are one device wide there).  With
    more cards than shards the JAX pod gives each shard a group of ``cards
    // shards`` devices on a stream = 1 mesh; a port mesh spans one device
    in a process, so here shard ``s`` runs on card ``s`` alone and the
    cards past the last shard stay idle."""
    if cards < 1:
        raise ValueError(f"a pod needs at least one card, got {cards}")
    return shard % cards


def _beams_per_shard(mesh: Mesh, beams: int) -> int:
    n_beam = mesh.shape["beam"]
    if beams % n_beam:
        raise ValueError(f"beams={beams} not divisible by beam axis {n_beam}")
    return beams // n_beam


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One process's slice of the beam axis and its all-reduce."""

    b_local: int
    offset: int
    group: Optional[object]  # the beam row's process group; None at extent 1
    reduce: str


def _shard_of(mesh: Mesh, cfg: FilterConfig) -> _Shard:
    if cfg.voxel_reduce not in ("psum", "ring"):
        raise ValueError(f"unknown voxel_reduce mode {cfg.voxel_reduce!r} (psum|ring)")
    b_local = _beams_per_shard(mesh, cfg.beams)
    return _Shard(b_local, mesh.coords[1] * b_local, mesh.beam_group, cfg.voxel_reduce)


# ---------------------------------------------------------------------------
# per-shard primitives (the single-device originals in ops/filters.py,
# re-derived with global beam-index arithmetic)
# ---------------------------------------------------------------------------


def _resample_keys_shard(batch: ScanBatch, cfg: FilterConfig, sh: _Shard):
    """Shard-local (beam_local, packed, in_slice) keys for this beam
    slice: every point of the stream's scan is seen, those whose global
    beam lands outside [offset, offset+b_local) carry _INT_INF (at local
    beam 0, where the min ignores them).  The clip folds into the mask,
    and malformed angles clamp to the edge beams, as in the JAX package."""
    ok = batch.valid & (batch.dist_q2 != 0)
    if cfg.enable_clip:
        ok = ok & _clip_ok(batch, cfg)
    beam_global = torch.div(batch.angle_q14 * cfg.beams, 65536, rounding_mode="floor")
    beam_local = beam_global.clamp(0, cfg.beams - 1) - sh.offset
    in_slice = ok & (beam_local >= 0) & (beam_local < sh.b_local)
    packed = (batch.dist_q2 << 8) | batch.quality.clamp(0, 255)
    packed = packed.masked_fill(~in_slice, _INT_INF)
    return beam_local.masked_fill(~in_slice, 0), packed, in_slice


def _grid_resample_shard(batch: ScanBatch, cfg: FilterConfig, sh: _Shard):
    """Scatter-min the stream's point set into this shard's beam slice."""
    beam_local, packed, _ = _resample_keys_shard(batch, cfg, sh)
    return _scatter_min(beam_local, packed, sh.b_local)


def _polar_to_cartesian_shard(ranges: torch.Tensor, cfg: FilterConfig, sh: _Shard):
    """ops.filters.polar_to_cartesian at global beam angles: the host-built
    trig table of all ``cfg.beams`` beams, sliced at the shard's offset."""
    finite = torch.isfinite(ranges)
    r = ranges.masked_fill(~finite, 0.0)
    table = _trig_table(cfg.beams, ranges.device)[sh.offset : sh.offset + sh.b_local]
    return r[..., None] * table, finite


def _voxel_hits_partial(xy: torch.Tensor, mask: torch.Tensor, cfg: FilterConfig) -> torch.Tensor:
    """This beam shard's partial (..., G, G) occupancy counts (either voxel
    op — counts are additive over beam shards)."""
    return select_voxel_hits(cfg.voxel_backend)(xy, mask, cfg.grid, cfg.cell_m)


def _ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce(+) as a ring: N-1 hops, each sending the rotating
    payload to the next rank of ``group`` and adding the one received.
    Semantically ``psum`` (int32 adds commute exactly).  On a gloo group
    a CUDA payload is staged through pinned host tensors."""
    global ring_host_hops
    if group is None:
        return x
    n = dist.get_world_size(group)
    if n == 1:
        return x
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    acc = x.clone()
    # graftlint: disable=GL001 — gloo has no CUDA transport: a CUDA payload
    # on a gloo group stages through pinned host memory (counted by
    # ring_host_hops); NCCL groups and CPU tensors never take this branch
    rot = x.cpu().pin_memory() if staged else x.contiguous()
    for _ in range(n - 1):
        recv = torch.empty(rot.shape, dtype=rot.dtype, device=rot.device, pin_memory=staged)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, rot, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group),
        ])
        for r in reqs:
            r.wait()
        rot = recv
        acc += rot.to(x.device, non_blocking=True) if staged else rot
        if staged:
            ring_host_hops += 1
    return acc


def _all_reduce(x: torch.Tensor, group, mode: str) -> torch.Tensor:
    if mode == "ring":
        return _ring_all_reduce(x, group)
    if mode != "psum":
        raise ValueError(f"unknown voxel_reduce mode {mode!r} (psum|ring)")
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _inc_median_step(state: FilterState, ranges: torch.Tensor, rows, cur, cfg: FilterConfig):
    """The incremental medians of every local stream in ONE B2 launch (or
    its plain version): the carried sorted windows laid side by side as a
    (W, S*b) stripe, each stream evicting its own cursor's row — read
    before the ring is written (the caller writes it after)."""
    if state.median_sorted is None:
        raise ValueError(
            "median_backend='inc' requires a state carrying the sorted window "
            "(create_sharded_state provides it per config)"
        )
    s, b = ranges.shape
    old_v = state.range_window[rows, cur].reshape(-1)
    stripe = _stripe(state.median_sorted)
    if pin_inc_lowering(cfg.median_backend, ranges.device.type) == "inc_pallas":
        from rplidar_ros2_driver_tpu_torch.ops.median_kernels import sorted_replace_kernel

        ms, med = sorted_replace_kernel(stripe, old_v, ranges.reshape(-1))
    else:
        ms = sorted_replace(stripe, old_v, ranges.reshape(-1))
        med = median_from_sorted(ms)
    state.median_sorted = _unstripe(ms, (s,)).contiguous()
    return med.reshape(s, b)


def _filter_step_shard(state: FilterState, batch: ScanBatch, cfg: FilterConfig, sh: _Shard):
    """One step of every local stream on this (stream, beam) shard,
    batched over the streams (each with its own cursor).  Beam-local
    throughout except the voxel partial-sum all-reduce at the end.
    Updates ``state`` in place; the output's ``voxel`` IS the accumulator
    (copy it before the next step)."""
    ranges, inten = _grid_resample_shard(batch, cfg, sh)  # (S, b)
    w = state.range_window.shape[1]
    rows = torch.arange(ranges.shape[0], device=ranges.device)
    cur = state.cursor.long()
    inc = cfg.enable_median and cfg.median_backend.startswith("inc")
    med = _inc_median_step(state, ranges, rows, cur, cfg) if inc else ranges
    state.range_window[rows, cur] = ranges
    state.inten_window[rows, cur] = inten
    if cfg.enable_median and not inc:
        # one B1 launch (or the plain sort) over the (W, S*b) ring stripe
        if cfg.median_backend == "pallas":
            from rplidar_ros2_driver_tpu_torch.ops.median_kernels import temporal_median_kernel

            med = temporal_median_kernel(_stripe(state.range_window))
        elif cfg.median_backend == "xla":
            med = temporal_median(_stripe(state.range_window))
        else:
            raise ValueError(f"unknown median_backend {cfg.median_backend!r}")
        med = med.reshape(ranges.shape)
    xy, mask = _polar_to_cartesian_shard(med, cfg, sh)

    if cfg.enable_voxel:
        new_hits = _all_reduce(_voxel_hits_partial(xy, mask, cfg), sh.group, sh.reduce)
        old_hits = state.hit_window[rows, cur]
        state.voxel_acc.add_(new_hits).sub_(old_hits)
        state.hit_window[rows, cur] = new_hits

    state.filled.add_(1).clamp_(max=w)
    state.cursor.add_(1).remainder_(w)
    out = FilterOutput(ranges=med, intensities=inten, points_xy=xy, point_mask=mask,
                       voxel=state.voxel_acc)
    return state, out


def _filter_scan_shard(state: FilterState, packed_seq: torch.Tensor, counts: torch.Tensor,
                       cfg: FilterConfig, sh: _Shard):
    """Every local stream's fused K-scan chain on this shard:
    ops.filters.fused_scan_core with the shard primitives injected —
    beam-local resample keys, shard-offset Cartesian projection, and ONE
    voxel all-reduce for the min(K, W) surviving hit grids of the whole
    block.  The same trajectory as K successive :func:`_filter_step_shard`
    calls."""

    def keys_fn(batch):
        beam_local, packed, _ = _resample_keys_shard(batch, cfg, sh)
        return beam_local, packed

    def hits_fn(xy, mask):
        return _all_reduce(_voxel_hits_partial(xy, mask, cfg), sh.group, sh.reduce)

    return fused_scan_core(
        state, packed_seq, counts, cfg,
        keys_fn=keys_fn,
        polar_fn=lambda rows: _polar_to_cartesian_shard(rows, cfg, sh),
        hits_fn=hits_fn,
    )


# ---------------------------------------------------------------------------
# public builders
# ---------------------------------------------------------------------------

# which axes of the stream-batched state and batch lie on which mesh axis
# (the JAX package's PartitionSpecs; None = whole on every shard)
STATE_SPEC = {
    "range_window": ("stream", None, "beam"),
    "inten_window": ("stream", None, "beam"),
    "hit_window": ("stream", None, None, None),  # whole on every beam shard (post-reduce)
    "voxel_acc": ("stream", None, None),
    "cursor": ("stream",),
    "filled": ("stream",),
    # the derived sorted window of ``inc`` shards exactly like the ring
    "median_sorted": ("stream", None, "beam"),
}
BATCH_SPEC = {k: ("stream", None) for k in ("angle_q14", "dist_q2", "quality", "flag", "valid")}
BATCH_SPEC["count"] = ("stream",)


def _local_block(mesh: Mesh, x, spec: Sequence, streams: int, beams: int):
    """This process's block of a global array along ``spec``'s axes."""
    idx = tuple(
        mesh.local_streams(streams) if ax == "stream"
        else mesh.local_beams(beams) if ax == "beam"
        else slice(None)
        for ax in spec
    )
    return x[idx]


_STATE_DTYPES = {
    "range_window": torch.float32, "inten_window": torch.float32,
    "median_sorted": torch.float32, "hit_window": torch.int32,
    "voxel_acc": torch.int32, "cursor": torch.int32, "filled": torch.int32,
}


def _to_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A COPY of ``x`` on ``device`` (a CPU ``from_numpy`` would alias
    the caller's buffer, and the step updates the state in place)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype, copy=True)
    return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)


def build_sharded_step(mesh: Mesh, cfg: FilterConfig):
    """The multi-stream filter step over ``mesh``.

    Signature: ``step(state, batch) -> (state, out)`` on this process's
    block: every field of ``state``/``batch`` has a leading LOCAL stream
    axis, ``cfg.beams`` divides by the beam extent, and the state's beam
    axes hold the local ``b_local`` columns.  ``state`` is updated in
    place; ``out`` owns its memory."""
    sh = _shard_of(mesh, cfg)

    def step(state: FilterState, batch: ScanBatch):
        state, out = _filter_step_shard(state, batch.to(mesh.device), cfg, sh)
        return state, dataclasses.replace(out, voxel=out.voxel.clone())

    return step


def build_sharded_scan(mesh: Mesh, cfg: FilterConfig):
    """The fused multi-scan replay over ``mesh`` (the fleet analog of
    ops.filters.compact_filter_scan).

    Signature: ``scan(state, packed_seq, counts) -> (state, ranges)``
    where ``packed_seq`` is the local (streams, K, 3, N) uint16 block
    (numpy, or the bytes as an int16 tensor), ``counts`` (streams, K)
    int32, and ``ranges`` comes back (streams, K, b_local).  One median
    launch and one voxel all-reduce per call; the same trajectory as K
    successive ``build_sharded_step`` calls."""
    sh = _shard_of(mesh, cfg)

    def scan(state: FilterState, packed_seq, counts):
        if isinstance(packed_seq, np.ndarray):
            packed_seq = torch.from_numpy(np.ascontiguousarray(packed_seq).view(np.int16))
        if isinstance(counts, np.ndarray):
            counts = torch.from_numpy(np.asarray(counts, np.int32))
        return _filter_scan_shard(
            state, packed_seq.to(mesh.device), counts.to(mesh.device), cfg, sh
        )

    return scan


def place_state(mesh: Mesh, state, *, beams: Optional[int] = None) -> FilterState:
    """A GLOBAL stream-batched state (a FilterState, or the snapshot dict
    of numpy arrays) as this process's block on ``mesh.device``, copied —
    the one placement point for fresh and restored state.  ``beams``
    defaults to the range window's width."""
    get = state.get if isinstance(state, dict) else (lambda k: getattr(state, k))
    rw = get("range_window")
    streams, beams = rw.shape[0], beams or rw.shape[-1]
    fields = {}
    for f in dataclasses.fields(FilterState):
        v = get(f.name)
        fields[f.name] = None if v is None else _to_device(
            _local_block(mesh, v, STATE_SPEC[f.name], streams, beams), mesh.device,
            _STATE_DTYPES[f.name])
    return FilterState(**fields)


def create_sharded_state(mesh: Mesh, cfg: FilterConfig, streams: int) -> FilterState:
    """This process's block of a fresh stream-batched FilterState: the
    ``inc`` backends carry the sorted window (all +inf: trivially
    sorted)."""
    s_local = mesh.local_streams(streams)
    s = s_local.stop - s_local.start
    b = _beams_per_shard(mesh, cfg.beams)
    dev = mesh.device
    f32, i32 = torch.float32, torch.int32
    return FilterState(
        range_window=torch.full((s, cfg.window, b), float("inf"), dtype=f32, device=dev),
        inten_window=torch.zeros((s, cfg.window, b), dtype=f32, device=dev),
        hit_window=torch.zeros((s, cfg.window, cfg.grid, cfg.grid), dtype=i32, device=dev),
        voxel_acc=torch.zeros((s, cfg.grid, cfg.grid), dtype=i32, device=dev),
        cursor=torch.zeros((s,), dtype=i32, device=dev),
        filled=torch.zeros((s,), dtype=i32, device=dev),
        median_sorted=(
            torch.full((s, cfg.window, b), float("inf"), dtype=f32, device=dev)
            if cfg.median_backend.startswith("inc") else None
        ),
    )


def abstract_sharded_state(mesh: Mesh, cfg: FilterConfig, streams: int) -> FilterState:
    """The restore template of the sharded checkpoints
    (utils/checkpoint_sharded.py): :func:`create_sharded_state`'s GLOBAL
    shapes and dtypes as meta tensors — no device allocation — with the
    same validation, and without the derived ``median_sorted`` (checkpoints
    exclude it; ``load_sharded`` recomputes it when the config needs it).
    Shapes come from ``FilterState.shapes`` so they cannot drift from the
    single-stream constructor."""
    if streams % mesh.shape["stream"]:
        raise ValueError(
            f"streams={streams} not divisible by stream axis {mesh.shape['stream']}"
        )
    _beams_per_shard(mesh, cfg.beams)  # the beam axis must divide too
    per = FilterState.shapes(cfg.window, cfg.beams, cfg.grid)
    return FilterState(**{
        f.name: None if f.name not in per else torch.empty(
            (streams, *per[f.name]), dtype=_STATE_DTYPES[f.name], device="meta")
        for f in dataclasses.fields(FilterState)
    })


def shard_batch(mesh: Mesh, batch: ScanBatch) -> ScanBatch:
    """This process's stream rows of a GLOBAL stream-batched ScanBatch, on
    the mesh's device."""
    streams = batch.count.shape[0]
    return ScanBatch(**{
        f.name: _local_block(mesh, getattr(batch, f.name), BATCH_SPEC[f.name], streams, 1)
        .to(mesh.device)
        for f in dataclasses.fields(ScanBatch)
    })


class FleetTopology:
    """Stream -> (shard, lane) placement planner for the elastic fleet
    (the JAX package's ``parallel/service.ElasticFleetService``).

    A *shard* is one engine pair (FleetFusedIngest + FleetMapper)
    compiled for a FIXED lane count; a *lane* is one row of its
    stream-batched state.  Lanes beyond the hosted streams are the
    idle padding lanes the compiled programs already encode (a None
    tick item = the all-masked idle frame), so every membership change
    this planner performs — join, leave, evacuation, rebalance — is a
    relabeling of which lanes are live, never a shape change: **zero
    recompiles by construction** (the same guarantee the quarantine
    masking rides, guards-pinned).

    Capacity invariant: with S shards of L lanes, the planner refuses
    a fleet that cannot survive one full shard loss —
    ``(S - 1) * L >= streams`` for S > 1 — so an evacuation always
    finds idle lanes (the ``shard_lanes`` auto default in
    core/config.py picks the smallest such L).  Host-side bookkeeping
    only: no device work.

    Two-level coordinates (pod of pods): ``hosts`` partitions the
    shards into contiguous equal blocks — shard s lives on host
    ``s // (shards // hosts)`` — and every stream gains a
    ``(host, shard, lane)`` coordinate (:meth:`coordinate`).  The
    relabeling discipline is unchanged (a host is only a grouping of
    lane tables), but placement becomes per-host-first: ``assign``
    picks the least-loaded HOST before the least-loaded shard within
    it, ``evacuate`` prefers same-host destinations (an intra-host
    move is a device-to-device row copy; a cross-host move must ship
    the row between processes), and ``rebalance_into`` pulls from
    same-host sources before crossing a host boundary.  With
    ``hosts=1`` every preference key is constant and the planner is
    byte-identical to the single-level rules above.
    """

    def __init__(
        self, streams: int, shards: int, lanes: int, hosts: int = 1,
    ) -> None:
        if streams < 1:
            raise ValueError("need at least one stream")
        if shards < 1:
            raise ValueError("need at least one shard")
        if lanes < 1:
            raise ValueError("need at least one lane per shard")
        if shards * lanes < streams:
            raise ValueError(
                f"{shards} shards x {lanes} lanes cannot host "
                f"{streams} streams"
            )
        if shards > 1 and (shards - 1) * lanes < streams:
            raise ValueError(
                f"{shards} shards x {lanes} lanes cannot survive a "
                f"shard loss with {streams} streams (need "
                f"(shards-1)*lanes >= streams)"
            )
        if hosts < 1:
            raise ValueError("need at least one host")
        if shards % hosts != 0:
            # contiguous equal blocks keep host_of O(1) and match the
            # contiguous device-group mesh slicing in the service — a
            # ragged split would leave one host's pod under-provisioned
            # relative to its device slice
            raise ValueError(
                f"{shards} shards cannot split evenly across "
                f"{hosts} hosts"
            )
        self.streams = streams
        self.shards = shards
        self.lanes = lanes
        self.hosts = hosts
        self.shards_per_host = shards // hosts
        # per-stream placement weights (byte-rate-weighted placement,
        # ROADMAP item 4): load is the SUM of hosted weights, so
        # ``assign``/``evacuate``/``rebalance_into`` land hot streams
        # on cold shards instead of counting streams.  Default 1.0 per
        # stream — every load compare degrades to the original
        # stream-count heuristic until a scheduler feeds measured
        # rates (parallel/scheduler.ByteRateEwma via set_weight).
        self._weights: dict[int, float] = {}
        # lane tables: _lane_map[shard][lane] = stream or None (idle)
        self._lane_map: list[list] = [
            [None] * lanes for _ in range(shards)
        ]
        # stream -> (shard, lane); absent = unhosted
        self._placement: dict[int, tuple[int, int]] = {}
        # initial placement: round-robin across shards, so losing any
        # one shard strands ~streams/shards victims, not a whole block
        for i in range(streams):
            self._place(i, i % shards)

    # -- queries -----------------------------------------------------------

    def placement(self, stream: int) -> Optional[tuple[int, int]]:
        """``(shard, lane)`` hosting ``stream``, or None (unhosted)."""
        return self._placement.get(stream)

    def streams_on(self, shard: int) -> list[int]:
        """Hosted streams of ``shard``, in lane order."""
        return [s for s in self._lane_map[shard] if s is not None]

    def lane_items(self, shard: int, items: Sequence) -> list:
        """Route a GLOBAL per-stream item list into ``shard``'s
        lane-ordered list (None for idle lanes) — the per-shard
        ``submit_bytes`` layout."""
        return [
            None if s is None else items[s]
            for s in self._lane_map[shard]
        ]

    def unhosted(self) -> list[int]:
        return [
            i for i in range(self.streams) if i not in self._placement
        ]

    # -- two-level (host) queries ------------------------------------------

    def host_of(self, shard: int) -> int:
        """The host owning ``shard`` (contiguous equal blocks)."""
        if not (0 <= shard < self.shards):
            raise IndexError(
                f"shard {shard} out of range [0, {self.shards})"
            )
        return shard // self.shards_per_host

    def shards_on_host(self, host: int) -> list[int]:
        """``host``'s shard ids, ascending."""
        if not (0 <= host < self.hosts):
            raise IndexError(
                f"host {host} out of range [0, {self.hosts})"
            )
        base = host * self.shards_per_host
        return list(range(base, base + self.shards_per_host))

    def coordinate(self, stream: int) -> Optional[tuple[int, int, int]]:
        """``(host, shard, lane)`` hosting ``stream``, or None."""
        got = self._placement.get(stream)
        if got is None:
            return None
        shard, lane = got
        return (self.host_of(shard), shard, lane)

    def host_load(self, host: int) -> float:
        """``host``'s weighted load: the sum over its shards."""
        return sum(self.shard_load(s) for s in self.shards_on_host(host))

    # -- weights -----------------------------------------------------------

    def weight_of(self, stream: int) -> float:
        """``stream``'s placement weight (1.0 until measured)."""
        return self._weights.get(stream, 1.0)

    def set_weight(self, stream: int, weight: float) -> None:
        """Set one stream's placement weight (a measured byte-rate
        signal, e.g. ``1.0 + ewma_bytes_per_tick / scale``).  Must be
        positive — a zero weight would make a hot stream invisible to
        every load compare; clamped to a small floor instead so an
        idle stream still occupies *some* balance mass (pure-zero
        weights would pile every idle stream onto one shard)."""
        if not (0 <= stream < self.streams):
            raise IndexError(
                f"stream {stream} out of range [0, {self.streams})"
            )
        self._weights[stream] = max(float(weight), 1e-6)

    def set_weights(self, weights) -> None:
        """Bulk :meth:`set_weight` — ``weights`` is a per-stream
        sequence or a ``{stream: weight}`` mapping."""
        items = (
            weights.items() if hasattr(weights, "items")
            else enumerate(weights)
        )
        for i, w in items:
            self.set_weight(i, w)

    def shard_load(self, shard: int) -> float:
        """``shard``'s weighted load: the sum of its hosted streams'
        weights."""
        return sum(self.weight_of(s) for s in self.streams_on(shard))

    # -- membership changes ------------------------------------------------

    def _free_lane(self, shard: int) -> Optional[int]:
        for lane, s in enumerate(self._lane_map[shard]):
            if s is None:
                return lane
        return None

    def _place(self, stream: int, shard: int) -> tuple[int, int]:
        lane = self._free_lane(shard)
        if lane is None:
            raise ValueError(f"shard {shard} has no idle lane")
        self._lane_map[shard][lane] = stream
        self._placement[stream] = (shard, lane)
        return (shard, lane)

    def release(self, stream: int) -> None:
        """Stream leaves the fleet (or goes unhosted): its lane reverts
        to idle padding."""
        got = self._placement.pop(stream, None)
        if got is not None:
            shard, lane = got
            self._lane_map[shard][lane] = None

    def assign(
        self,
        stream: int,
        avoid: Sequence[int] = (),
        prefer_host: Optional[int] = None,
    ) -> Optional[tuple[int, int]]:
        """Place an unhosted ``stream`` per host first, cross-host
        second: among hosts with a candidate shard (idle lane, not in
        ``avoid``) the least WEIGHTED-loaded host wins, then the
        least-loaded candidate shard within it — load is the weighted
        sum (:meth:`shard_load`), so a shard hosting one hot stream
        counts as fuller than one hosting two cold ones.
        ``prefer_host`` (the evacuation path) pins the host choice to
        the named host whenever it still has a candidate — an
        intra-host move is a row copy between device slices; crossing
        a host boundary ships the row between processes.  With one
        host both keys are constant and this is exactly the original
        least-loaded-shard rule.  Returns the new (shard, lane) or
        None when no candidate shard remains."""
        if stream in self._placement:
            raise ValueError(f"stream {stream} is already hosted")
        # candidate shards per host, then a two-level pick: host key
        # (preference, weighted host load, index) before shard key
        # (weighted shard load, index)
        best, best_key = None, None
        for shard in range(self.shards):
            if shard in avoid or self._free_lane(shard) is None:
                continue
            host = self.host_of(shard)
            key = (
                0 if host == prefer_host else 1,
                self.host_load(host),
                host,
                self.shard_load(shard),
                shard,
            )
            if best_key is None or key < best_key:
                best, best_key = shard, key
        if best is None:
            return None
        return self._place(stream, best)

    def evacuate(
        self, shard: int, avoid: Sequence[int] = (),
    ) -> list[tuple[int, int, int]]:
        """Plan the moves off a LOST ``shard``: every victim stream is
        released and reassigned to the least-loaded surviving shard's
        idle lane.  ``avoid`` names OTHER shards that must not receive
        victims (the service passes every non-hosting shard, so a
        double loss cannot evacuate onto an earlier casualty's empty
        lanes).  Returns ``[(stream, dst_shard, dst_lane), ...]`` in
        lane order; victims that found no lane stay unhosted (absent
        from the plan) — the capacity invariant makes that impossible
        for a single shard loss, but a double loss degrades instead of
        raising."""
        victims = self.streams_on(shard)
        skip = frozenset(avoid) | {shard}
        plan = []
        # heaviest victims place first (stable on ties, so equal-weight
        # fleets keep the original lane order): each assign updates the
        # weighted loads the next one compares, so the hot streams take
        # the coldest shards before the cold ones fill the gaps.  The
        # lost shard's own host is preferred per victim — same-host
        # siblings take the refugees before any cross the host boundary
        for stream in sorted(
            victims, key=lambda s: -self.weight_of(s)
        ):
            self.release(stream)
            got = self.assign(
                stream, avoid=skip, prefer_host=self.host_of(shard)
            )
            if got is not None:
                plan.append((stream, got[0], got[1]))
        return plan

    def rebalance_into(self, shard: int) -> list[tuple[int, int, int, int, int]]:
        """Plan the migrations BACK onto a re-admitted (empty) ``shard``
        until it is balanced: streams move from the most-loaded shard
        (by WEIGHTED load) while doing so strictly improves balance —
        a move of weight w improves iff ``load[src] - load[dst] > w``
        (it strictly decreases the sum of squared loads, so the loop
        terminates), and among improving candidates the HEAVIEST
        stream moves, landing hot streams on the cold re-admitted
        shard first.  With all weights at the 1.0 default this is
        exactly the original stream-count rule.  Returns
        ``[(stream, src_shard, src_lane, dst_shard, dst_lane), ...]``
        (src -1/-1 for streams that were unhosted — they need no
        migration source); the source lane rides along because the
        mover must snapshot the live state from it BEFORE the
        relabeling takes effect."""
        moves: list[tuple[int, int, int, int, int]] = []
        for stream in sorted(
            self.unhosted(), key=lambda s: -self.weight_of(s)
        ):
            if self._free_lane(shard) is None:
                break
            _, lane = self._place(stream, shard)
            moves.append((stream, -1, -1, shard, lane))
        dst_host = self.host_of(shard)
        while self._free_lane(shard) is not None:
            dst_load = self.shard_load(shard)
            # the best improving move across EVERY source shard — not
            # just the most-loaded one, whose sole tenant may be too
            # heavy to move while a lighter sibling still has improving
            # candidates.  Preference order (same-host source, then
            # heaviest stream, then most-loaded source, then highest
            # shard index, then last lane) reproduces the original
            # count rule exactly at equal weights on one host; across
            # hosts it drains same-host siblings before shipping rows
            # over a host boundary.
            best = None  # ((same_host, w, src_load, src, pos), stream, src)
            for s in range(self.shards):
                if s == shard:
                    continue
                sl = self.shard_load(s)
                same = 1 if self.host_of(s) == dst_host else 0
                for pos, stream in enumerate(self.streams_on(s)):
                    w = self.weight_of(stream)
                    if sl - dst_load > w:
                        key = (same, w, sl, s, pos)
                        if best is None or key > best[0]:
                            best = (key, stream, s)
            if best is None:
                break  # no move improves balance any further
            _, stream, src = best
            src_lane = self._placement[stream][1]
            self.release(stream)
            _, lane = self._place(stream, shard)
            moves.append((stream, src, src_lane, shard, lane))
        return moves

    def lane_streams(self, shard: int) -> list:
        """``shard``'s raw lane table (stream id or None per lane) — the
        inverse of :meth:`lane_items` for routing outputs back."""
        return list(self._lane_map[shard])

    def status(self) -> list[dict]:
        """Per-shard host dicts (the /diagnostics topology surface);
        ``load`` is the weighted placement load (== stream count until
        a scheduler feeds measured byte rates)."""
        return [
            {
                "host": self.host_of(s),
                "streams": self.streams_on(s),
                "lanes": self.lanes,
                "load": round(self.shard_load(s), 3),
            }
            for s in range(self.shards)
        ]
