"""Pluggable ScanFilterChain — the seam between wrapper and publisher.

The BASELINE.json north star: a filter chain inserted between the driver
wrapper and the ``/scan`` publisher, device-selected via the parameter
surface (``filter_backend: cpu | tpu | cuda``).  ``tpu`` (the default,
meaning "the accelerator") and ``cuda`` run the step on ``cuda:0`` and
raise when no card is present; only ``cpu`` keeps the chain on the host.
The host FSM and publishing stay identical either way.

Also owns the framework's checkpoint surface: the rolling window and voxel
accumulator are real state, so ``snapshot``/``restore`` let a lifecycle
deactivate/activate cycle — or a RESETTING recovery — either preserve or
deterministically reset the window.  Snapshots are the JAX package's
format, so a window carries across the two packages.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, ScanBatch
from rplidar_ros2_driver_tpu_torch.ops.filters import (
    FilterConfig,
    FilterOutput,
    FilterState,
    counted_filter_step_wire,
    filter_step,
    pack_host_scan_counted,
    pin_inc_lowering,
    unpack_output_wire,
    wire_output_len,
)
from rplidar_ros2_driver_tpu_torch.utils.fetch import bounded_fetch

log = logging.getLogger("rplidar_tpu.chain")


def pick_device(backend: str) -> torch.device:
    """``filter_backend`` -> torch device.  ``cpu`` is the host; ``tpu``
    and ``cuda`` are the accelerator, ``cuda:0``, and raise when CUDA is
    unavailable — never a silent fall back to the host."""
    if backend == "cpu":
        return torch.device("cpu")
    if backend in ("tpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"filter_backend={backend!r} needs a CUDA device and none is "
                "available; set filter_backend: cpu to run on the host"
            )
        return torch.device("cuda", 0)
    raise ValueError(f"unknown filter_backend {backend!r}")


DEFAULT_BEAMS = 2048


def resolve_median_backend(
    requested: str, platform: str, window: Optional[int] = None
) -> str:
    """Resolve the ``auto`` median backend for a device type; explicit
    requests pass through.

    - CUDA: "pallas", the B1 selection kernel — the same choice the JAX
      package makes for its accelerator.  PERF.md carries the B1-vs-B2
      A/B on the card that a later change may flip this on.
    - CPU: "inc", the O(W) incremental median (lowered to its plain
      form on the host)."""
    if requested != "auto":
        return requested
    del window  # no measured crossover by depth yet
    try:
        return {"cuda": "pallas", "cpu": "inc"}[platform]
    except KeyError:
        raise ValueError(f"no median backend for device type {platform!r}") from None


def resolve_ingest_backend(requested: str, platform: Optional[str] = None) -> str:
    """Resolve the ``auto`` ingest backend; explicit requests (``host`` or
    ``fused``) pass through.  ``host`` is the golden path (host decode and
    revolution assembly + the chain's one-upload step); ``fused`` is the
    device ingest engine driver/ingest.FusedIngest (ops/ingest.py: decode,
    segmentation, de-skew and the filter step on the device), held to
    the host path bit for bit.  ``auto`` stays ``host``, as in the JAX
    package."""
    if requested != "auto":
        return requested
    del platform
    return "host"


def resolve_fleet_ingest_backend(requested: str, platform: Optional[str] = None) -> str:
    """Resolve the ``auto`` fleet ingest backend (``host``), mirroring
    :func:`resolve_ingest_backend`; ``fused`` is
    driver/ingest.FleetFusedIngest, every stream's bytes to filter outputs
    in one step per tick."""
    if requested != "auto":
        return requested
    del platform
    return "host"


def resolve_resample_backend(requested: str, platform: Optional[str] = None) -> str:
    """Resolve the ``auto`` streaming-step resampler: ``scatter``
    (scatter_reduce amin; the dense tile materializes a beams x capacity
    mask per scan) on every device until a measurement says otherwise."""
    if requested != "auto":
        return requested
    return "scatter"


def resolve_voxel_backend(requested: str, platform: Optional[str] = None) -> str:
    """Resolve the ``auto`` voxel-accumulation op: ``scatter``
    (index_add_ histogram) on every device until a measurement says
    otherwise."""
    if requested != "auto":
        return requested
    return "scatter"


def config_from_params(
    params: DriverParams, beams: int = DEFAULT_BEAMS, platform: str = "cuda"
) -> FilterConfig:
    """The one params -> FilterConfig mapping.  ``platform`` (the torch
    device type) resolves ``auto`` and pins the ``inc`` lowering."""
    chain = set(params.filter_chain)
    return FilterConfig(
        window=params.filter_window,
        beams=beams,
        grid=params.voxel_grid_size,
        cell_m=params.voxel_cell_m,
        range_min_m=params.range_clip_min_m,
        range_max_m=params.range_clip_max_m,
        intensity_min=params.intensity_min,
        enable_clip="clip" in chain,
        enable_median="median" in chain,
        enable_voxel="voxel" in chain,
        median_backend=pin_inc_lowering(
            resolve_median_backend(
                params.median_backend, platform, window=params.filter_window
            ),
            platform,
        ),
        resample_backend=resolve_resample_backend(params.resample_backend, platform),
        voxel_backend=resolve_voxel_backend(params.voxel_backend, platform),
    )


class _Fetch:
    """One step's wire output on its way to the host: the host tensor it
    lands in and, on CUDA, the event recorded after its non-blocking
    copy.  ``wait`` blocks until the bytes are host-side."""

    def __init__(self, host: torch.Tensor, event: Optional[torch.cuda.Event]) -> None:
        self.host = host
        self.event = event

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ScanFilterChain:
    """Stateful host wrapper around the filter step.

    Thread-safety: the step updates the state tensors in place, so a
    concurrent ``snapshot()`` — e.g. a checkpoint requested while the scan
    thread streams — could read a half-updated window.  Every method that
    reads or swaps the state (process/process_raw/snapshot/restore)
    serializes on one lock, uncontended in steady state (one scan
    thread).  The ``state`` property is the one unsynchronized accessor
    (debug/tests).

    Per revolution on CUDA: one pinned host->device copy of the packed
    scan, the step's launches on the current stream, one non-blocking
    device->host copy of the flat output into a pinned buffer, and a CUDA
    event the collect waits on.
    """

    def __init__(
        self,
        params: DriverParams,
        beams: int = DEFAULT_BEAMS,
        *,
        warmup: bool = True,
        capacity: Optional[int] = None,
    ) -> None:
        self.device = pick_device(params.filter_backend)
        self.cfg = config_from_params(params, beams, platform=self.device.type)
        # wire capacity (nodes per packed upload): an oversized revolution
        # is truncated head-keep like the assembler's overflow cap, never
        # raised — a crash would take down the scan thread mid-stream
        self.capacity = capacity
        self.collect_timeout_s = params.collect_timeout_s
        self._overflow_warned = False
        self._lock = threading.Lock()
        self._state = FilterState.for_config(self.cfg, device=self.device)
        # double-buffered publish seam: the not-yet-collected output of the
        # newest dispatched step (process_raw_pipelined); _epoch advances
        # on restore/reset so a failed dispatch cannot re-stash a
        # pre-restore output
        self._pending: Optional[_Fetch] = None
        self._epoch = 0
        # seconds the newest pipelined collect spent waiting for the
        # pending output's device->host copy, and the newest pipelined
        # tick's upload + step dispatch: the split of the publish latency
        # an end-to-end run reads
        self.last_collect_wait_s = 0.0
        self.last_upload_dispatch_s = 0.0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            n = (capacity or MAX_SCAN_NODES) + 1
            self._in_host = torch.empty((3, n), dtype=torch.int16, pin_memory=True)
            self._in_done: Optional[torch.cuda.Event] = None
            # two output buffers: step N lands in one while N-1's bytes
            # may still wait for their collect in the other
            self._out_host = [
                torch.empty((wire_output_len(self.cfg),), dtype=torch.float32, pin_memory=True)
                for _ in range(2)
            ]
            self._out_next = 0
        if warmup:
            self.precompile()

    def precompile(self) -> None:
        """Build/load the step's kernels now and run the step once, so the
        first real revolution pays neither.  Runs one zero-count step
        through the production wire path: on a FRESH state the all-masked
        scan writes only values the state already holds (+inf range row,
        zero intensities/hits), and the cursor/filled advance is rolled
        back, so state is exactly as if this never ran.  On a state that
        has already absorbed scans the step would overwrite the current
        ring row, so it is skipped."""
        with self._lock:
            if int(self._state.filled) != 0:
                return
            zeros = np.zeros(0, np.int32)
            buf = pack_host_scan_counted(zeros, zeros, zeros, None, self.capacity)
            counted_filter_step_wire(self._state, self._upload(buf), self.cfg)
            self._state.cursor.zero_()
            self._state.filled.zero_()
            if self._cuda:
                torch.cuda.synchronize(self.device)

    def _pack_capped(self, angle_q14, dist_q2, quality, flag):
        """Pack one scan at ``self.capacity``, truncating an oversized
        revolution head-keep with a one-time warning instead of raising
        out of the scan thread."""
        n = self.capacity
        if n is not None and len(angle_q14) > n:
            if not self._overflow_warned:
                log.warning(
                    "revolution of %d nodes exceeds wire capacity %d; "
                    "truncating (head-keep) — raise the chain's capacity "
                    "if this device/mode can legitimately exceed it",
                    len(angle_q14), n,
                )
                self._overflow_warned = True
            angle_q14, dist_q2, quality = angle_q14[:n], dist_q2[:n], quality[:n]
            flag = flag[:n] if flag is not None else None
        return pack_host_scan_counted(angle_q14, dist_q2, quality, flag, n)

    def _upload(self, buf: np.ndarray) -> torch.Tensor:
        """The packed (3, n+1) uint16 wire buffer on the chain's device, as
        int16 (same bytes).  On CUDA it goes through the pinned staging
        buffer, reused once the previous upload has landed."""
        wire = torch.from_numpy(buf.view(np.int16))
        if not self._cuda:
            return wire
        if self._in_done is not None:
            self._in_done.synchronize()
        self._in_host.copy_(wire)  # same (3, capacity + 1) shape by construction
        dev = self._in_host.to(self.device, non_blocking=True)
        self._in_done = torch.cuda.Event()
        self._in_done.record(torch.cuda.current_stream(self.device))
        return dev

    def _start_fetch(self, wire: torch.Tensor) -> _Fetch:
        """Start the device->host copy of one step's wire output."""
        if not self._cuda:
            return _Fetch(wire, None)
        host = self._out_host[self._out_next]
        self._out_next ^= 1
        host.copy_(wire, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Fetch(host, event)

    def _step(self, buf: np.ndarray) -> _Fetch:
        # the upload holds the lock too: the pinned staging buffer is shared
        with self._lock:
            packed = self._upload(buf)
            self._state, wire = counted_filter_step_wire(self._state, packed, self.cfg)
            return self._start_fetch(wire)

    def process(self, batch: ScanBatch) -> FilterOutput:
        """ScanBatch-level step (tensors out, on the chain's device)."""
        batch = batch.to(self.device)
        with self._lock:
            self._state, out = filter_step(self._state, batch, self.cfg)
        return out

    def process_raw(self, angle_q14, dist_q2, quality, flag=None) -> FilterOutput:
        """Streaming ingest of raw host arrays via the packed one-upload
        path — the production hot path: per revolution, one host->device
        copy (bit-packed (3, N) uint16 with the node count folded into the
        last column), the step, and one device->host copy of the flat
        output.  Returns a numpy-backed FilterOutput."""
        buf = self._pack_capped(angle_q14, dist_q2, quality, flag)
        return self._collect(self._step(buf))

    def process_raw_pipelined(
        self, angle_q14, dist_q2, quality, flag=None
    ) -> Optional[FilterOutput]:
        """Pipelined publish seam: dispatch THIS revolution's step, then
        return the PREVIOUS revolution's output — one revolution of bounded
        staleness in exchange for never waiting on device compute at
        publish time (the device-side mirror of the reference's
        double-buffered ScanDataHolder, sl_lidar_driver.cpp:237-371).

        The returned output's step finished — and its non-blocking
        device->host copy was enqueued — during the previous
        inter-revolution gap, so the collect here usually finds the bytes
        host-side already.  The pending output is collected BEFORE this
        revolution's upload/dispatch.  Returns None on the first call
        after a start/reset (nothing pending); :meth:`flush_pipelined`
        drains the final pending output when the stream stops."""
        buf = self._pack_capped(angle_q14, dist_q2, quality, flag)
        with self._lock:
            pending, self._pending = self._pending, None
            epoch = self._epoch
        out = None
        self.last_collect_wait_s = 0.0
        if pending is not None:
            t_collect = time.perf_counter()
            try:
                out = self._collect(pending)
                self.last_collect_wait_s = time.perf_counter() - t_collect
            except Exception:
                # the fetch of N-1 itself failed: re-stash it so
                # flush_pipelined can retry, instead of losing it
                self._restash_pending(pending, epoch)
                raise
        # reset before the attempt: a failed upload/dispatch must not
        # leave the previous tick's duration attributed to this one
        self.last_upload_dispatch_s = 0.0
        t_dispatch = time.perf_counter()
        try:
            fetch = self._step(buf)
            with self._lock:
                self._pending = fetch
            self.last_upload_dispatch_s = time.perf_counter() - t_dispatch
        except Exception:
            # upload/dispatch of N failed AFTER N-1 was popped: re-stash
            # N-1 so the caller's drain can still publish it
            if pending is not None:
                self._restash_pending(pending, epoch)
            raise
        with self._lock:
            if self._epoch != epoch:
                # a restore/reset raced in after the pop: the popped
                # output is pre-restore and must not be published
                out = None
        return out

    def _restash_pending(self, pending: _Fetch, epoch: int) -> None:
        """Put a popped-but-unpublished output back for the drain — unless
        a restore/reset moved the epoch meanwhile or a newer dispatch
        already stashed its own."""
        with self._lock:
            if self._pending is None and self._epoch == epoch:
                self._pending = pending

    def _collect(self, fetch: _Fetch) -> FilterOutput:
        """Wait for one output's bytes and unpack them, bounded by
        ``collect_timeout_s`` when set (utils/fetch.bounded_fetch) — the
        analog of the reference's timed grab (sl_lidar_driver.h:332)."""
        return bounded_fetch(
            lambda: unpack_output_wire(fetch.wait(), self.cfg),
            self.collect_timeout_s,
            "publish collect (device->host)",
        )

    def discard_pipelined(self) -> None:
        """Drop the pending pipelined output without fetching it (for
        callers whose failure policy is drop-not-retry)."""
        with self._lock:
            self._pending = None

    def flush_pipelined(self) -> Optional[FilterOutput]:
        """Collect the last dispatched step's output (the one revolution
        still in flight when the stream stops), or None.  On a fetch
        fault/timeout the output is re-stashed for a later retry and the
        error surfaces to the caller."""
        with self._lock:
            pending, self._pending = self._pending, None
            epoch = self._epoch
        if pending is None:
            return None
        try:
            return self._collect(pending)
        except Exception:
            self._restash_pending(pending, epoch)
            raise

    # -- checkpoint surface -------------------------------------------------

    def snapshot(self) -> dict[str, np.ndarray]:
        """Host copy of the rolling window + accumulator, in the JAX
        package's format.  A device-side copy is taken under the lock
        (cheap), then the lock is released before the host copy, so a
        checkpoint never stalls the hot path for a device->host fetch."""
        with self._lock:
            state = self._state.clone()
        return state.to_numpy()

    @staticmethod
    def _shape_mismatch(
        snap: dict, window: int, beams: int, grid: int
    ) -> Optional[tuple[dict, dict]]:
        """(got, expected) when incompatible, None when compatible.
        Host-side — no device transfer.  A derived median_sorted key is
        ignored."""
        expected = FilterState.shapes(window, beams, grid)
        got = {
            k: tuple(np.asarray(v).shape)
            for k, v in snap.items()
            if k != "median_sorted"
        }
        return None if expected == got else (got, expected)

    @classmethod
    def snapshot_compatible(
        cls, params: DriverParams, snap: dict, beams: Optional[int] = None
    ) -> bool:
        """Would a chain built from ``params`` accept this snapshot?  The
        single source of truth for pre-validation (node.load_checkpoint)."""
        return (
            cls._shape_mismatch(
                snap,
                params.filter_window,
                beams if beams is not None else DEFAULT_BEAMS,
                params.voxel_grid_size,
            )
            is None
        )

    def compatible(self, snap: dict) -> bool:
        return (
            self._shape_mismatch(snap, self.cfg.window, self.cfg.beams, self.cfg.grid)
            is None
        )

    def restore(self, snap: Optional[dict]) -> bool:
        """Restore a snapshot, or reset deterministically when None.

        A snapshot taken under different chain parameters is rejected with
        a warning and the chain's CURRENT state is left untouched.
        Returns True when the snapshot was restored, False when it wasn't
        (cold reset for None, or rejected mismatch)."""
        if snap is not None:
            mismatch = self._shape_mismatch(
                snap, self.cfg.window, self.cfg.beams, self.cfg.grid
            )
            if mismatch is not None:
                got, expected = mismatch
                log.warning(
                    "rejecting incompatible filter snapshot (%s != %s)", got, expected
                )
                return False
        # build the new device state OUTSIDE the lock (the upload is
        # several MB at default geometry); only the swap holds the lock
        if snap is None:
            fresh = FilterState.for_config(self.cfg, device=self.device)
        else:
            fresh = FilterState.from_numpy(
                snap, device=self.device,
                with_sorted=self.cfg.median_backend.startswith("inc"),
            )
        with self._lock:
            self._state = fresh
            self._pending = None  # pre-restore output: never publish
            self._epoch += 1
        return snap is not None

    def reset(self) -> None:
        self.restore(None)

    @property
    def state(self) -> FilterState:
        """The live device state — UNSYNCHRONIZED debug/test accessor.
        The next step updates these tensors in place; use
        :meth:`snapshot` from any thread that does not own the stream."""
        return self._state
