"""Intra-process pub/sub bus — the zero-copy composition transport.

Equivalent of rclcpp intra-process comms enabled by the reference's
composition launch (launch/composition.launch.py:67): messages published by
a node in the container are delivered to same-process subscribers as the
same object reference, never serialized.  QoS semantics follow the
reference's two modes (src/rplidar_node.cpp:154-172): ``best_effort``
subscribers get a bounded newest-wins queue; ``reliable`` subscribers get an
unbounded queue.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Any, Callable, Optional

log = logging.getLogger("rplidar_tpu.bus")

from rplidar_ros2_driver_tpu_torch.node.messages import (
    DiagnosticStatus,
    LaserScanHost,
    PointCloudHost,
    StaticTransform,
)
from rplidar_ros2_driver_tpu_torch.node.publisher import PublisherBase


class _Subscription:
    def __init__(self, callback: Optional[Callable], reliable: bool, maxlen: int) -> None:
        self.callback = callback
        self.queue: collections.deque = collections.deque(
            maxlen=None if reliable else maxlen
        )
        self.lock = threading.Lock()
        self._latest_seq = -1
        # pending callback deliveries; drained by exactly one thread at a
        # time so callbacks run OUTSIDE the lock (no ABBA deadlock, no
        # serialization of publishers behind a slow callback) yet stay
        # ordered per subscription (enqueue order is decided under the lock)
        self._cb_pending: collections.deque = collections.deque()
        self._draining = False

    def deliver(self, msg: Any, seq: int = -1, *, replay: bool = False) -> None:
        """Deliver msg.  A stale latched REPLAY (older seq than something
        already enqueued on this subscription) is dropped, so a publish
        racing the replay can never be overwritten by the older message;
        live publishes are never dropped (reliable keeps all)."""
        with self.lock:
            if seq >= 0:
                if replay and seq < self._latest_seq:
                    return
                self._latest_seq = max(self._latest_seq, seq)
            if self.callback is None:
                self.queue.append(msg)
                return
            self._cb_pending.append(msg)
            if self._draining:
                return  # the draining thread will pick it up, in order
            self._draining = True
        try:
            while True:
                with self.lock:
                    if not self._cb_pending:
                        # cleared atomically with the emptiness check, so a
                        # racing publish either sees pending+draining or
                        # empty+not-draining — never a stranded message
                        self._draining = False
                        return
                    nxt = self._cb_pending.popleft()
                try:
                    self.callback(nxt)
                except Exception:
                    # a raising subscriber must not propagate into the
                    # publisher's thread (in the node hot path that would
                    # turn every publish into an FSM reset); rclcpp
                    # intra-process delivery does not crash the publisher
                    log.exception("subscriber callback raised; message dropped")
        except BaseException:
            # non-Exception escape (KeyboardInterrupt/SystemExit): release
            # the drain claim; whatever is still pending is delivered by
            # the next publish
            with self.lock:
                self._draining = False
            raise

    def drain(self) -> list:
        with self.lock:
            out = list(self.queue)
            self.queue.clear()
        return out


_NO_LATCHED = object()  # sentinel: None is a publishable message


class IntraProcessBus:
    """Topic registry shared by every node in a :class:`NodeContainer`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._topics: dict[str, list[_Subscription]] = {}
        # latched topics replay the last message to late subscribers —
        # the transient-local behaviour /tf_static relies on in ROS 2.
        # values are (msg, seq): the per-topic sequence number orders a
        # replay against concurrent publishes.
        self._latched: dict[str, tuple[Any, int]] = {}
        self._seq: dict[str, int] = {}

    def subscribe(
        self,
        topic: str,
        callback: Optional[Callable] = None,
        *,
        reliable: bool = False,
        maxlen: int = 64,
    ) -> _Subscription:
        sub = _Subscription(callback, reliable, maxlen)
        with self._lock:
            self._topics.setdefault(topic, []).append(sub)
            replay = self._latched.get(topic, _NO_LATCHED)
        # deliver the latched replay outside the bus lock (like publish),
        # so a callback that re-enters the bus cannot deadlock; the seq
        # guard in deliver() drops it if a newer publish won the race
        if replay is not _NO_LATCHED:
            msg, seq = replay
            sub.deliver(msg, seq, replay=True)
        return sub

    def publish(self, topic: str, msg: Any, *, latched: bool = False) -> int:
        """Deliver ``msg`` (by reference — zero copy) to all subscribers."""
        with self._lock:
            subs = list(self._topics.get(topic, ()))
            seq = self._seq.get(topic, 0) + 1
            self._seq[topic] = seq
            if latched:
                self._latched[topic] = (msg, seq)
        for sub in subs:
            sub.deliver(msg, seq)
        return len(subs)

    def topic_names(self) -> list[str]:
        with self._lock:
            return sorted(set(self._topics) | set(self._latched))


class BusPublisher(PublisherBase):
    """PublisherBase adapter that routes onto an :class:`IntraProcessBus`.

    Topic names mirror the reference node's: ``<ns>/scan``,
    ``<ns>/points``, ``/tf_static``, ``/diagnostics``
    (src/rplidar_node.cpp:154-208).
    """

    def __init__(self, bus: IntraProcessBus, namespace: str = "") -> None:
        self.bus = bus
        ns = namespace.rstrip("/")
        self.scan_topic = f"{ns}/scan"
        self.cloud_topic = f"{ns}/points"
        self.tf_topic = "/tf_static"
        self.diag_topic = "/diagnostics"

    def publish_scan(self, msg: LaserScanHost) -> None:
        self.bus.publish(self.scan_topic, msg)

    def publish_cloud(self, msg: PointCloudHost) -> None:
        self.bus.publish(self.cloud_topic, msg)

    def publish_tf_static(self, tf: StaticTransform) -> None:
        self.bus.publish(self.tf_topic, tf, latched=True)

    def publish_diagnostics(self, status: DiagnosticStatus) -> None:
        self.bus.publish(self.diag_topic, status)
