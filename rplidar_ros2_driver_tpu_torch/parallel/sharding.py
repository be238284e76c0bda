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

**One process, several devices.**  JAX runs one controller over many
devices and its ``shard_map`` program holds every shard.  Here a
:class:`Mesh` takes one of two forms:

  * **held in this process**: a ``(stream, beam)`` grid of devices
    (``mesh.devices``), each block a separate set of tensors on its own
    device — every visible card by default (:func:`make_mesh`), or a given
    list; a list that repeats a device (``[cpu] * 8``, or four blocks on
    ``cuda:0``) runs the same block split on fewer devices.  A step runs
    every block's front half on its device, sums each stream row's voxel
    partials in the process (``psum`` onto the row's first block and back,
    or a ``ring`` of N-1 peer hops, each followed by an int32 add), then
    every block's back half; outputs come back in global stream and beam
    order on the lead device (block ``(0, 0)``).  The ``(1, 1)`` mesh is
    the one-block case;
  * **one device per process** (PyTorch's SPMD idiom): a
    ``torch.distributed`` ``DeviceMesh`` whose ``"beam"`` group carries the
    voxel all-reduce, and this process's view of it — the axis extents,
    its device and its coordinates.  The process at mesh coordinates
    ``(i, j)`` holds streams ``[i*S/s, (i+1)*S/s)`` and beams ``[j*B/b,
    (j+1)*B/b)``.

The functions below take a block's view (:attr:`Mesh.blocks`), so both
forms share every per-block line; on a mesh held in this process a state
is the list of its blocks' states (:func:`create_sharded_state`).

The local streams of a block are batched, never looped: one step is one
median launch a block (B1, or B2 for ``inc``), its rings laid side by side
as one ``(W, S_local*b_local)`` stripe, and one fused chunk is one B3
launch a block over the ``(W+K, S_local*b_local)`` history stripe.

Across processes the all-reduce is ``psum`` (``dist.all_reduce(SUM)``) or an
explicit ``ring`` of N-1 ``batch_isend_irecv`` hops
(``FilterConfig.voxel_reduce``); int32 adds are exact in any order, so the
two are bit-equal.  On a gloo group the ring stages each hop of a CUDA
tensor through pinned host tensors — explicitly, only in that mode,
counted in ``ring_host_hops`` — since gloo's point-to-point ops are
host-memory transports (its all-reduce takes CUDA tensors).  NCCL refuses
two ranks on one device; two processes sharing one card use gloo.  In one
process every copy between two cards goes through :func:`peer_copy`,
counted in ``peer_copies``.

The fused fleet ingest (driver/ingest.FleetFusedIngest) has no collective:
its streams are independent pipelines.  JAX places its state
``P("stream", None, ...)``, each stream row replicated over the row's beam
devices; here a mesh row's streams are computed once, on the row's lead
block (:func:`fleet_rows`, :func:`place_fleet_ingest_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.utils.rowops import map_state, zip_states
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    FilterConfig,
    FilterOutput,
    FilterState,
    _clip_ok,
    _scatter_min,
    _stripe,
    _trig_table,
    _unstripe,
    fused_scan_back,
    fused_scan_core,
    fused_scan_front,
    median_from_sorted,
    pin_inc_lowering,
    select_voxel_hits,
    sorted_replace,
    temporal_median,
)

_INT_INF = 0x7FFFFFFF

# ring hops of a CUDA tensor staged through host memory (gloo groups)
ring_host_hops = 0
# copies between two devices of a mesh held in one process (peer_copy)
peer_copies = 0


def _visible_cards() -> list:
    """Every visible card; raises without CUDA (never a silent host
    fallback — pass ``device="cpu"`` to run on the host)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh needs a CUDA device and none is available; pass "
            "device='cpu' to run the mesh on the host"
        )
    return [torch.device("cuda", d) for d in range(torch.cuda.device_count())]


def _default_device() -> torch.device:
    """The card of this process in a process group: ``cuda:(rank %
    cards)``; raises without CUDA."""
    cards = _visible_cards()
    return cards[dist.get_rank() % len(cards)]


class Mesh:
    """A ``(stream, beam)`` mesh: the axis extents (``shape``), the lead
    device (``device``: block ``(0, 0)``, or this process's block), this
    view's ``coords``, and either the grid of devices this process holds
    (``devices``, a (stream, beam) object array) or, when the mesh spans
    processes, the ``DeviceMesh`` that holds the per-axis groups.  Built
    with neither, it is one block's view: what :attr:`blocks` hands the
    per-block functions."""

    def __init__(self, stream: int, beam: int, device, *, coords=(0, 0),
                 device_mesh=None, devices=None) -> None:
        self.shape = {"stream": int(stream), "beam": int(beam)}
        self.device = torch.device(device)
        self.coords = tuple(int(c) for c in coords)
        self.device_mesh = device_mesh
        self.devices = None
        self._blocks = None
        if devices is not None:
            grid = np.empty((int(stream), int(beam)), dtype=object)
            for k, d in enumerate(devices):
                grid.flat[k] = torch.device(d)
            self.devices = grid
            if grid.size > 1:
                self._blocks = [Mesh(stream, beam, grid[i, j], coords=(i, j))
                                for i in range(int(stream)) for j in range(int(beam))]

    @property
    def spans_processes(self) -> bool:
        return self.device_mesh is not None

    @property
    def multi_block(self) -> bool:
        """This process holds several blocks of the mesh."""
        return self.devices is not None and self.devices.size > 1

    @property
    def blocks(self) -> list:
        """Each block this process holds as a one-block view (the mesh's
        extents, the block's coords and device), row-major; ``[self]``
        when it holds one.  Built once, with the mesh."""
        return [self] if self._blocks is None else self._blocks

    @property
    def beam_group(self):
        """The process group of this process's beam row (None when the
        beam axis has extent 1, or in one process: no collective)."""
        if self.device_mesh is None or self.shape["beam"] == 1:
            return None
        return self.device_mesh["beam"].get_group()

    def local_streams(self, streams: int) -> slice:
        """The stream rows this process (or this block) holds."""
        s = self.shape["stream"]
        if streams % s:
            raise ValueError(f"streams={streams} not divisible by stream axis {s}")
        if self.multi_block:
            return slice(0, streams)
        per = streams // s
        return slice(self.coords[0] * per, (self.coords[0] + 1) * per)

    def local_beams(self, beams: int) -> slice:
        """The beam columns this process (or this block) holds."""
        b_local = _beams_per_shard(self, beams)
        if self.multi_block:
            return slice(0, beams)
        return slice(self.coords[1] * b_local, (self.coords[1] + 1) * b_local)

    def __repr__(self) -> str:
        where = (f"devices={[str(d) for d in self.devices.flat]}" if self.multi_block
                 else f"device={self.device}, coords={self.coords}")
        return f"Mesh(stream={self.shape['stream']}, beam={self.shape['beam']}, {where})"


def _squarest(n: int) -> int:
    """The stream extent of the squarest split of ``n`` with stream <=
    beam."""
    for s in range(int(np.sqrt(n)), 0, -1):
        if n % s == 0:
            return s
    return 1


def make_mesh(
    n_devices: Optional[int] = None,
    stream: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Mesh:
    """Build a 2-D ``(stream, beam)`` mesh.  ``stream`` fixes the
    data-parallel extent; the beam axis takes the rest (default: the
    squarest split with stream <= beam, as in the JAX package).

    Without a process group (or with ``devices``) the mesh is held in this
    process over ``devices`` — by default every visible card, or
    ``[device]`` when ``device`` is given (``device="cpu"``: the ``(1, 1)``
    host mesh) — cut to the first ``n_devices``.  A list may repeat a
    device (``[cpu] * 8``).  In a process group ``n_devices`` defaults to
    the world size and the mesh spans every process (one device each, this
    process's ``device``); ``n_devices=1`` gives this process a mesh of its
    own."""
    if devices is None and dist.is_initialized():
        return _process_mesh(n_devices, stream, device)
    if devices is None:
        devices = [torch.device(device)] if device is not None else _visible_cards()
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
    stream = _squarest(n_devices) if stream is None else stream
    if n_devices % stream:
        raise ValueError(f"stream={stream} does not divide {n_devices} devices")
    devices = devices[:n_devices]
    return Mesh(stream, n_devices // stream, devices[0], devices=devices)


def _process_mesh(n_devices: Optional[int], stream: Optional[int], device) -> Mesh:
    """The mesh over the processes of the group, one device each."""
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, only {world} available")
    if n_devices not in (1, world):
        raise ValueError(
            f"a mesh over processes spans one device or every process of the "
            f"group ({world}), not {n_devices}"
        )
    stream = _squarest(n_devices) if stream is None else stream
    if n_devices % stream:
        raise ValueError(f"stream={stream} does not divide {n_devices} devices")
    device = torch.device(device) if device is not None else _default_device()
    if n_devices == 1:
        return Mesh(1, 1, device, devices=[device])
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (stream, n_devices // stream),
                          mesh_dim_names=("stream", "beam"))
    return Mesh(stream, n_devices // stream, device, coords=tuple(dm.get_coordinate()),
                device_mesh=dm)


def pod_groups(shards: int, cards: int) -> list:
    """The cards of each serving-pod shard, the JAX pod's group rule:
    ``per = max(1, cards // shards)`` cards a shard, shard ``s`` on cards
    ``(s*per + k) % cards`` for k < per.  With more cards than shards each
    shard gets a group of cards (its mesh ``(1, per)`` over them); with
    fewer, the shards take the cards round-robin, one each."""
    if cards < 1:
        raise ValueError(f"a pod needs at least one card, got {cards}")
    per = max(1, cards // shards)
    return [[(s * per + k) % cards for k in range(per)] for s in range(shards)]


def shard_card(shard: int, cards: int) -> int:
    """The card of serving-pod shard ``shard`` when each shard has one
    card: :func:`pod_groups`' rule at ``per = 1``, ``shard % cards``."""
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


@dataclasses.dataclass
class _StepFront:
    """What the front half of a step hands its back half: the step's
    outputs, the ring rows and cursors it writes, and the voxel partial
    (None without the voxel stage)."""

    med: torch.Tensor
    inten: torch.Tensor
    xy: torch.Tensor
    mask: torch.Tensor
    rows: torch.Tensor
    cur: torch.Tensor
    partial: Optional[torch.Tensor]


def _step_front(state: FilterState, batch: ScanBatch, cfg: FilterConfig, sh: _Shard) -> _StepFront:
    """The front half of one step of every local stream on this (stream,
    beam) block, batched over the streams (each with its own cursor):
    resample, ring write, median, projection and the voxel partial — all
    beam-local."""
    ranges, inten = _grid_resample_shard(batch, cfg, sh)  # (S, b)
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
    partial = _voxel_hits_partial(xy, mask, cfg) if cfg.enable_voxel else None
    return _StepFront(med, inten, xy, mask, rows, cur, partial)


def _step_back(state: FilterState, front: _StepFront, new_hits: Optional[torch.Tensor]):
    """The back half once the voxel hits are summed over the beam row
    (``new_hits``, None without the voxel stage): the accumulator, the hit
    ring, the fill count and the cursor.  The output's ``voxel`` IS the
    accumulator (copy it before the next step)."""
    w = state.range_window.shape[1]
    if new_hits is not None:
        old_hits = state.hit_window[front.rows, front.cur]
        state.voxel_acc.add_(new_hits).sub_(old_hits)
        state.hit_window[front.rows, front.cur] = new_hits
    state.filled.add_(1).clamp_(max=w)
    state.cursor.add_(1).remainder_(w)
    out = FilterOutput(ranges=front.med, intensities=front.inten, points_xy=front.xy,
                       point_mask=front.mask, voxel=state.voxel_acc)
    return state, out


def _filter_step_shard(state: FilterState, batch: ScanBatch, cfg: FilterConfig, sh: _Shard):
    """One step of every local stream on this process's block: the front
    half, the voxel partial-sum all-reduce over the beam group, the back
    half.  Updates ``state`` in place; the output's ``voxel`` IS the
    accumulator (copy it before the next step)."""
    front = _step_front(state, batch, cfg, sh)
    hits = None if front.partial is None else _all_reduce(front.partial, sh.group, sh.reduce)
    return _step_back(state, front, hits)


def _scan_primitives(cfg: FilterConfig, sh: _Shard, reduce: bool) -> dict:
    """The shard primitives ops.filters.fused_scan_core takes on this
    block: beam-local resample keys, shard-offset Cartesian projection,
    and the block's hit grids — summed over the beam group when
    ``reduce``, else partial (blocks summed in this process)."""

    def keys_fn(batch):
        beam_local, packed, _ = _resample_keys_shard(batch, cfg, sh)
        return beam_local, packed

    def hits_fn(xy, mask):
        partial = _voxel_hits_partial(xy, mask, cfg)
        return _all_reduce(partial, sh.group, sh.reduce) if reduce else partial

    return dict(keys_fn=keys_fn, polar_fn=lambda rows: _polar_to_cartesian_shard(rows, cfg, sh),
                hits_fn=hits_fn)


def _filter_scan_shard(state: FilterState, packed_seq: torch.Tensor, counts: torch.Tensor,
                       cfg: FilterConfig, sh: _Shard):
    """Every local stream's fused K-scan chain on this process's block:
    ops.filters.fused_scan_core with the shard primitives injected, ONE
    voxel all-reduce for the min(K, W) surviving hit grids of the whole
    block.  The same trajectory as K successive :func:`_filter_step_shard`
    calls."""
    return fused_scan_core(state, packed_seq, counts, cfg, **_scan_primitives(cfg, sh, True))


# ---------------------------------------------------------------------------
# the blocks of a mesh held in one process
# ---------------------------------------------------------------------------


def peer_copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the one copy between two devices of a mesh held
    in one process (``x`` itself when it is there already).  Between two
    cards PyTorch's device-to-device copy orders it after the producer's
    work on the source card's current stream and the consumer's current
    stream after it (events both ways, no host synchronisation); it is a
    peer copy where the two cards have peer access, else CUDA stages
    it.  Counted in ``peer_copies``."""
    global peer_copies
    if x.device == device:
        return x
    peer_copies += 1
    return x.contiguous().to(device, non_blocking=True)


def _stage(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device`` once: a host tensor goes to a card through
    page-locked memory, asynchronously (PyTorch's pinned host allocator
    keeps the staging block until its copy has landed); a device tensor
    moves by :func:`peer_copy`."""
    if x.device.type != "cpu":
        return peer_copy(x, device)
    if device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def _rows(mesh: Mesh, items: list) -> list:
    """A per-block list (row-major) split into the mesh's stream rows."""
    nb = mesh.shape["beam"]
    return [items[i * nb:(i + 1) * nb] for i in range(mesh.shape["stream"])]


def reduce_blocks(mesh: Mesh, partials: list, mode: str) -> list:
    """Sum each stream row's per-block voxel partials (row-major, one a
    block) in this process; returns each block's sum on its own device.
    ``psum`` adds the row's partials onto its first block and copies the
    sum back to the others; ``ring`` makes N-1 hops, every block's
    rotating payload going to the next block of the row, each hop
    followed by an int32 add.  int32 adds are exact in any order, so the
    two are bit-equal."""
    if mode not in ("psum", "ring"):
        raise ValueError(f"unknown voxel_reduce mode {mode!r} (psum|ring)")
    out = []
    for row in _rows(mesh, partials):
        n = len(row)
        if mode == "psum":
            acc = row[0]
            for p in row[1:]:
                acc = acc.add_(peer_copy(p, acc.device))
            out += [acc] + [peer_copy(acc, p.device) for p in row[1:]]
            continue
        acc = [p.clone() for p in row]
        rot = list(row)
        for _ in range(n - 1):
            rot = [peer_copy(rot[(j - 1) % n], row[j].device) for j in range(n)]
            for j in range(n):
                acc[j].add_(rot[j])
        out += acc
    return out


def _gather_output(mesh: Mesh, outs: list) -> FilterOutput:
    """The blocks' step outputs put together in global stream and beam
    order on the lead device (new tensors: ``torch.cat`` copies); a stream
    row's voxel is its first block's (every block of the row holds the
    same sum)."""
    lead = mesh.device
    rows = _rows(mesh, outs)

    def cat(name: str) -> torch.Tensor:
        return torch.cat([torch.cat([peer_copy(getattr(o, name), lead) for o in row], dim=1)
                          for row in rows])

    return FilterOutput(ranges=cat("ranges"), intensities=cat("intensities"),
                        points_xy=cat("points_xy"), point_mask=cat("point_mask"),
                        voxel=torch.cat([peer_copy(row[0].voxel, lead) for row in rows]))


def step_blocks(mesh: Mesh, cfg: FilterConfig, states: list, batches: list, shards: list):
    """One step of a mesh held in one process: every block's front half on
    its device (its stream rows ``batches[k]``, its beam columns, its
    ``shards[k]`` built once by the caller), the voxel partials summed over
    each stream row (:func:`reduce_blocks`), then every block's back half.
    Updates each block's state in place; returns (states, the global output
    on the lead device, owning its memory)."""
    fronts = [_step_front(st, b, cfg, sh) for st, b, sh in zip(states, batches, shards)]
    hits = ([None] * len(fronts) if not cfg.enable_voxel
            else reduce_blocks(mesh, [f.partial for f in fronts], cfg.voxel_reduce))
    outs = [_step_back(st, f, h)[1] for st, f, h in zip(states, fronts, hits)]
    return states, _gather_output(mesh, outs)


def scan_blocks(mesh: Mesh, cfg: FilterConfig, states: list, seqs: list, counts: list,
                shards: list):
    """One fused chunk of a mesh held in one process: every block's front
    half (one B3 launch a block over its history stripe), the hit grids of
    the chunk's surviving scans summed over each stream row, every block's
    back half.  Returns (states, the global (streams, K, beams) ranges on
    the lead device)."""
    fronts = [fused_scan_front(st, q, c, cfg, **_scan_primitives(cfg, sh, False))
              for st, q, c, sh in zip(states, seqs, counts, shards)]
    hits = ([None] * len(fronts) if not cfg.enable_voxel
            else reduce_blocks(mesh, [f.hits for f in fronts], cfg.voxel_reduce))
    meds = [fused_scan_back(st, f, h)[1] for st, f, h in zip(states, fronts, hits)]
    lead = mesh.device
    return states, torch.cat([torch.cat([peer_copy(m, lead) for m in row], dim=-1)
                              for row in _rows(mesh, meds)])


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


def block_states(state) -> list:
    """The per-block states of a sharded state: the list itself on a mesh
    held in one process with several blocks, else ``[state]``."""
    return state if isinstance(state, list) else [state]


def build_sharded_step(mesh: Mesh, cfg: FilterConfig):
    """The multi-stream filter step over ``mesh``.

    Signature: ``step(state, batch) -> (state, out)``.  On a one-block
    mesh (this process's block of a mesh over processes, or ``(1, 1)``)
    every field of ``state``/``batch`` has a leading LOCAL stream axis,
    ``cfg.beams`` divides by the beam extent, and the state's beam axes
    hold the local ``b_local`` columns.  On a mesh held in one process
    with several blocks ``state`` is the list of the blocks' states
    (:func:`create_sharded_state`), ``batch`` the global batch, and
    ``out`` the global output on the lead device (:func:`step_blocks`).
    ``state`` is updated in place; ``out`` owns its memory."""
    shards = [_shard_of(v, cfg) for v in mesh.blocks]
    if mesh.multi_block:
        def step_all(states: list, batch: ScanBatch):
            return step_blocks(mesh, cfg, states, shard_batch(mesh, batch), shards)

        return step_all

    def step(state: FilterState, batch: ScanBatch):
        state, out = _filter_step_shard(state, batch.to(mesh.device), cfg, shards[0])
        return state, dataclasses.replace(out, voxel=out.voxel.clone())

    return step


def build_sharded_scan(mesh: Mesh, cfg: FilterConfig):
    """The fused multi-scan replay over ``mesh`` (the fleet analog of
    ops.filters.compact_filter_scan).

    Signature: ``scan(state, packed_seq, counts) -> (state, ranges)``
    where ``packed_seq`` is the local (streams, K, 3, N) uint16 block
    (numpy, or the bytes as an int16 tensor), ``counts`` (streams, K)
    int32, and ``ranges`` comes back (streams, K, b_local).  One median
    launch a block and one voxel all-reduce per call; the same trajectory
    as K successive ``build_sharded_step`` calls.  On a mesh held in one
    process with several blocks ``state`` is the list of the blocks'
    states, the inputs are global and ``ranges`` is (streams, K, beams)
    on the lead device (:func:`scan_blocks`)."""
    shards = [_shard_of(v, cfg) for v in mesh.blocks]

    def scan(state, packed_seq, counts):
        if isinstance(packed_seq, np.ndarray):
            packed_seq = torch.from_numpy(np.ascontiguousarray(packed_seq).view(np.int16))
        if isinstance(counts, np.ndarray):
            counts = torch.from_numpy(np.asarray(counts, np.int32))
        if not mesh.multi_block:
            return _filter_scan_shard(
                state, packed_seq.to(mesh.device), counts.to(mesh.device), cfg, shards[0]
            )
        # each stream row's scans go up once, to the row's first block,
        # and on to the row's other blocks by peer_copy
        streams = counts.shape[0]
        seqs, cnts = [], []
        for row in _rows(mesh, mesh.blocks):
            rows = row[0].local_streams(streams)
            seq = _stage(packed_seq[rows], row[0].device)
            cnt = _stage(counts[rows], row[0].device)
            seqs += [peer_copy(seq, v.device) for v in row]
            cnts += [peer_copy(cnt, v.device) for v in row]
        return scan_blocks(mesh, cfg, state, seqs, cnts, shards)

    return scan


def place_state(mesh: Mesh, state, *, beams: Optional[int] = None):
    """A GLOBAL stream-batched state (a FilterState, or the snapshot dict
    of numpy arrays) as this process's block on ``mesh.device``, copied —
    the one placement point for fresh and restored state; on a mesh held
    in one process with several blocks, the list of every block's.
    ``beams`` defaults to the range window's width."""
    if mesh.multi_block:
        return [place_state(v, state, beams=beams) for v in mesh.blocks]
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


def create_sharded_state(mesh: Mesh, cfg: FilterConfig, streams: int):
    """This process's block of a fresh stream-batched FilterState (on a
    mesh held in one process with several blocks, the list of every
    block's, each on its own device): the ``inc`` backends carry the
    sorted window (all +inf: trivially sorted)."""
    if mesh.multi_block:
        return [create_sharded_state(v, cfg, streams) for v in mesh.blocks]
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


def gather_state(mesh: Mesh, state) -> dict:
    """The GLOBAL state as host numpy arrays keyed by field (the snapshot
    format; ``median_sorted`` included when carried), put together from
    the blocks of a mesh held in this process along :data:`STATE_SPEC`:
    beam-split fields joined along their beam axis within a stream row,
    the rest taken from the row's first block, the rows joined along the
    stream axis.  ``state`` is a sharded state, or a list of per-block
    dicts of tensors.  On a one-block mesh it is that block."""
    blocks = [st if isinstance(st, dict) else
              {f.name: getattr(st, f.name) for f in dataclasses.fields(FilterState)
               if getattr(st, f.name) is not None}
              for st in block_states(state)]
    host = [{k: v.cpu().numpy() for k, v in b.items()} for b in blocks]
    if len(host) == 1:
        return host[0]
    rows = _rows(mesh, host)
    out = {}
    for name in host[0]:
        spec = STATE_SPEC[name]
        parts = [np.concatenate([b[name] for b in row], axis=spec.index("beam"))
                 if "beam" in spec else row[0][name] for row in rows]
        out[name] = np.concatenate(parts, axis=spec.index("stream"))
    return out


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


def shard_batch(mesh: Mesh, batch: ScanBatch):
    """This process's stream rows of a GLOBAL stream-batched ScanBatch, on
    the mesh's device; on a mesh held in one process with several blocks,
    the list of every block's rows on its own device."""
    if mesh.multi_block:
        return [shard_batch(v, batch) for v in mesh.blocks]
    streams = batch.count.shape[0]
    return ScanBatch(**{
        f.name: _local_block(mesh, getattr(batch, f.name), BATCH_SPEC[f.name], streams, 1)
        .to(mesh.device)
        for f in dataclasses.fields(ScanBatch)
    })


# the fused fleet ingest's rows
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetRow:
    """One stream row of a mesh held in this process, as the fused fleet
    ingest (driver/ingest.FleetFusedIngest) places it: the global streams
    ``lanes`` of mesh row ``block[0]``, computed once on the row's lead
    block ``block`` = ``(row, 0)``, on ``device``."""

    block: tuple
    device: torch.device
    lanes: slice


def fleet_rows(mesh: Mesh, streams: int) -> list:
    """The rows of the fused fleet ingest over ``mesh`` — the JAX package's
    ``P("stream", None, ...)`` placement of that state: row ``r`` holds
    streams ``[r*N/R, (r+1)*N/R)``.  JAX replicates a row over its beam
    devices; here it is computed once, on the row's lead block.  A mesh
    of one block (the ``(1, 1)`` mesh, or one block's view) is one row on
    its device; a ``(1, C)`` mesh one row on card 0.  Raises JAX's
    ``ValueError`` when the stream axis does not divide ``streams``."""
    if mesh.spans_processes:
        raise ValueError("fleet rows are the rows of a mesh held in one process")
    if not mesh.multi_block:
        return [FleetRow((0, 0), mesh.device, slice(0, streams))]
    s = mesh.shape["stream"]
    if streams % s:
        raise ValueError(f"streams={streams} not divisible by stream axis {s}")
    per = streams // s
    return [FleetRow((r, 0), mesh.devices[r, 0], slice(r * per, (r + 1) * per))
            for r in range(s)]


def place_rows(rows: list, state) -> list:
    """A GLOBAL stream-batched state split into one state a row of
    ``rows`` (:class:`FleetRow`), each a copy on its row's device."""
    return [map_state(state, lambda v, row=row: v[row.lanes].to(row.device, copy=True))
            for row in rows]


def place_fleet_ingest_state(mesh: Mesh, state) -> list:
    """A GLOBAL stream-batched fleet ingest state (ops/ingest.IngestState,
    nested FilterState included) split into one state a row of
    :func:`fleet_rows`: the counterpart of the JAX package's
    ``place_fleet_ingest_state``."""
    return place_rows(fleet_rows(mesh, state.partial.shape[0]), state)


def gather_fleet_ingest_state(states: list):
    """The rows' states put back together in global stream order, as host
    tensors (the layout of a one-row engine)."""
    return zip_states(states, lambda vs: torch.cat([v.cpu() for v in vs]))


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
