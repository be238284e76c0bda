"""Complete-scan assembly: decoded node batches -> whole revolutions (a
copy of the JAX package's ``driver/assembly.py`` on this package's
ScanBatch; numpy only — it is the host golden assembler the fused device
ingest is held against).

Batched re-design of the reference's ``ScanDataHolder``
(sl_lidar_driver.cpp:237-371): the reference pushes one HQ node at a time
and swaps double buffers when a sync-flagged node arrives; here the decode
path delivers *batches* of nodes (the vectorized unpackers emit whole
capsule pairs), so assembly is batched too — find sync positions in the
batch, close out revolutions at each, keep the partial tail.

Concurrency contract matches the reference: a producer thread feeds
batches; one consumer blocks in ``wait_and_grab`` (Event-signalled, 2 s
default timeout, sl_lidar_driver.h:332).  Completed scans are double
buffered: if the consumer lags, the newest scan replaces the queued one
(the reference replaces the last entry when full, :302-305).  Data before
the first sync is discarded (:296-299).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, ScanBatch


class ScanAssembler:
    """Accumulates flat node arrays, emits complete revolutions."""

    def __init__(self, max_nodes: int = MAX_SCAN_NODES, on_complete=None) -> None:
        self._max_nodes = max_nodes
        # observer invoked (under the producer's push, lock held) with
        # each closed revolution's scan dict the moment it completes —
        # BEFORE newest-wins replacement can drop it.  The fused-ingest
        # parity suite uses it as the lossless golden tap; the consumer
        # contract (wait_and_grab*) is unchanged.
        self._on_complete = on_complete
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._pending: Optional[dict] = None      # newest complete scan
        self._partial: list[np.ndarray] = []      # [ (k,4) int32 chunks ]
        self._partial_ts_chunks: list[np.ndarray] = []  # [ (k,) f64 per-node ts ]
        self._partial_len = 0
        self._seen_first_sync = False
        self.scans_completed = 0
        self.scans_dropped = 0                    # overwritten before grab

    def reset(self) -> None:
        with self._lock:
            self._pending = None
            self._partial = []
            self._partial_ts_chunks = []
            self._partial_len = 0
            self._seen_first_sync = False
            self._event.clear()

    # -- producer side -----------------------------------------------------

    def push_nodes(
        self,
        angle_q14: np.ndarray,
        dist_q2: np.ndarray,
        quality: np.ndarray,
        flag: np.ndarray,
        ts=None,
    ) -> int:
        """Feed a flat, time-ordered batch of valid nodes.

        Returns the number of revolutions completed by this batch.  A node
        with flag bit0 set starts a new revolution (the reference swaps
        buffers on it, sl_lidar_driver.cpp:279-294).

        ``ts`` carries the (already back-dated, protocol/timing.py)
        measurement times: either a (n,) float64 array with one timestamp
        PER NODE (the exact path — revolution boundaries inside the batch
        each get their own begin time, correct during RPM transients), or a
        scalar stamping the whole batch (per-frame approximation), or None
        for "now".  The reference records per-scan begin timestamps the
        same way (sl_lidar_driver.cpp:293) but from per-node stamps.
        """
        n = len(angle_q14)
        if n == 0:
            return 0
        stacked = np.stack(
            [
                np.asarray(angle_q14, np.int32),
                np.asarray(dist_q2, np.int32),
                np.asarray(quality, np.int32),
                np.asarray(flag, np.int32),
            ],
            axis=1,
        )
        if ts is None:
            ts_arr = np.full(n, time.monotonic(), np.float64)
        elif np.ndim(ts) == 0:
            ts_arr = np.full(n, float(ts), np.float64)
        else:
            ts_arr = np.asarray(ts, np.float64)
            if ts_arr.shape != (n,):
                raise ValueError(f"ts shape {ts_arr.shape} != ({n},)")
        sync_pos = np.flatnonzero(stacked[:, 3] & 1)
        completed = 0
        with self._lock:
            start = 0
            for pos in sync_pos:
                if self._seen_first_sync:
                    self._append_partial(stacked[start:pos], ts_arr[start:pos])
                    # the sync node opening the NEXT revolution marks the
                    # end of this one
                    self._close_partial(end_ts=ts_arr[pos])
                    completed += 1
                # data before the very first sync is dropped
                self._partial = []
                self._partial_ts_chunks = []
                self._partial_len = 0
                self._seen_first_sync = True
                start = pos
            self._append_partial(stacked[start:], ts_arr[start:])
            if completed:
                self._event.set()
        return completed

    def _append_partial(self, chunk: np.ndarray, ts_chunk: np.ndarray) -> None:
        if not self._seen_first_sync or len(chunk) == 0:
            return
        room = self._max_nodes - self._partial_len
        if room <= 0:
            return  # scan overflow: excess nodes dropped (cap 8192)
        chunk = chunk[:room]
        self._partial.append(chunk)
        self._partial_ts_chunks.append(ts_chunk[:room])
        self._partial_len += len(chunk)

    def _close_partial(self, end_ts: float = 0.0) -> None:
        if self._partial_len == 0:
            return
        scan = np.concatenate(self._partial, axis=0)
        node_ts = np.concatenate(self._partial_ts_chunks)
        if self._pending is not None:
            self.scans_dropped += 1  # consumer lagging: newest wins
        ts0 = float(node_ts[0])
        self._pending = {
            "angle_q14": scan[:, 0],
            "dist_q2": scan[:, 1],
            "quality": scan[:, 2],
            "flag": scan[:, 3],
            "node_ts": node_ts,
            "ts0": ts0,
            "duration": max(end_ts - ts0, 0.0),
        }
        self.scans_completed += 1
        self._partial = []
        self._partial_ts_chunks = []
        self._partial_len = 0
        if self._on_complete is not None:
            self._on_complete(self._pending)

    # -- consumer side -----------------------------------------------------

    def _take_pending(self) -> Optional[dict]:
        with self._lock:
            scan = self._pending
            self._pending = None
            self._event.clear()
        return scan

    def _to_batch(self, scan: dict) -> ScanBatch:
        return ScanBatch.from_numpy(
            scan["angle_q14"], scan["dist_q2"], scan["quality"], scan["flag"],
            n=self._max_nodes, device="cpu",
        )

    def wait_and_grab(self, timeout_s: float = 2.0) -> Optional[ScanBatch]:
        """Block until a complete revolution is available; None on timeout."""
        got = self.wait_and_grab_with_timestamp(timeout_s)
        return got[0] if got is not None else None

    def wait_and_grab_with_timestamp(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[ScanBatch, float, float]]:
        """Like wait_and_grab, plus the revolution's back-dated begin
        timestamp and measured duration (grabScanDataHqWithTimeStamp,
        sl_lidar_driver.cpp:783-806)."""
        got = self.wait_and_grab_host(timeout_s)
        if got is None:
            return None
        scan, ts0, duration = got
        return self._to_batch(scan), ts0, duration

    def wait_and_grab_host(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[dict, float, float]]:
        """Zero-device-touch grab: the revolution as plain numpy arrays
        (keys angle_q14/dist_q2/quality/flag) + begin timestamp + duration.
        The production chain path uses this so the ONLY host->device
        transfer per revolution is the single bit-packed ingest buffer."""
        if not self._event.wait(timeout_s):
            return None
        scan = self._take_pending()
        if scan is None:
            return None
        return scan, scan["ts0"], scan["duration"]

    def grab_nowait(self) -> Optional[ScanBatch]:
        scan = self._take_pending()
        if scan is None:
            return None
        return self._to_batch(scan)


class RawNodeHolder:
    """Bounded buffer of raw nodes for incomplete-scan interval retrieval.

    Analog of the reference's ``RawSampleNodeHolder`` (bounded deque of
    8192, sl_lidar_driver.cpp:186-235) behind ``getScanDataWithIntervalHq``
    (:962-966): a consumer fetches whatever arrived since its last fetch,
    without waiting for a sync-complete revolution — the low-latency tap
    for consumers that do their own scan segmentation.  When full, the
    oldest nodes are dropped.
    """

    def __init__(self, capacity: int = MAX_SCAN_NODES) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._chunks: list[np.ndarray] = []   # (k, 4) int32, time-ordered
        self._len = 0
        self.nodes_dropped = 0

    def reset(self) -> None:
        with self._lock:
            self._chunks = []
            self._len = 0

    def push(self, stacked: np.ndarray) -> None:
        """Append a (k, 4) [angle_q14, dist_q2, quality, flag] batch."""
        if len(stacked) == 0:
            return
        with self._lock:
            self._chunks.append(np.asarray(stacked, np.int32))
            self._len += len(stacked)
            while self._len > self._capacity:
                overflow = self._len - self._capacity
                head = self._chunks[0]
                if len(head) <= overflow:
                    self._chunks.pop(0)
                    self._len -= len(head)
                    self.nodes_dropped += len(head)
                else:
                    self._chunks[0] = head[overflow:]
                    self._len -= overflow
                    self.nodes_dropped += overflow

    def fetch(self, max_nodes: Optional[int] = None) -> Optional[np.ndarray]:
        """Non-blocking: drain up to ``max_nodes`` accumulated nodes as a
        (k, 4) array in arrival order; None when nothing is pending (or
        when ``max_nodes=0`` asks for nothing)."""
        with self._lock:
            if self._len == 0 or max_nodes == 0:
                return None
            data = np.concatenate(self._chunks, axis=0)
            if max_nodes is not None and len(data) > max_nodes:
                keep = data[max_nodes:]
                self._chunks = [keep]
                self._len = len(keep)
                data = data[:max_nodes]
            else:
                self._chunks = []
                self._len = 0
            return data
