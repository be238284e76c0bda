"""Managed-node lifecycle.

Mirror of the ROS 2 managed-node state machine the reference builds on
(rclcpp_lifecycle::LifecycleNode; transitions wired in
src/rplidar_node.cpp:116-262 and driven by launch/rplidar.launch.py:109-141):

    UNCONFIGURED --configure--> INACTIVE --activate--> ACTIVE
         ^                        |  ^                   |
         '-------cleanup----------'  '----deactivate-----'
    any --shutdown--> FINALIZED

Transition callbacks return bool; a False return leaves the state unchanged
(ERROR processing kept simple: failed configure stays UNCONFIGURED).
"""

from __future__ import annotations

import enum
import logging
import threading

log = logging.getLogger("rplidar_tpu.lifecycle")


class LifecycleState(enum.Enum):
    UNCONFIGURED = "unconfigured"
    INACTIVE = "inactive"
    ACTIVE = "active"
    FINALIZED = "finalized"


class LifecycleError(RuntimeError):
    pass


class LifecycleNode:
    """Base class enforcing legal transitions; subclasses override on_*."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._state = LifecycleState.UNCONFIGURED
        self._lock = threading.RLock()

    @property
    def lifecycle_state(self) -> LifecycleState:
        with self._lock:
            return self._state

    def _transition(self, expected, target, callback) -> bool:
        with self._lock:
            if self._state not in expected:
                raise LifecycleError(
                    f"{self.name}: cannot go {self._state.value} -> {target.value}"
                )
            ok = bool(callback())
            if ok:
                self._state = target
                log.info("%s: lifecycle -> %s", self.name, target.value)
            else:
                log.error("%s: transition to %s failed", self.name, target.value)
            return ok

    def configure(self) -> bool:
        return self._transition(
            (LifecycleState.UNCONFIGURED,), LifecycleState.INACTIVE, self.on_configure
        )

    def activate(self) -> bool:
        return self._transition(
            (LifecycleState.INACTIVE,), LifecycleState.ACTIVE, self.on_activate
        )

    def deactivate(self) -> bool:
        return self._transition(
            (LifecycleState.ACTIVE,), LifecycleState.INACTIVE, self.on_deactivate
        )

    def cleanup(self) -> bool:
        return self._transition(
            (LifecycleState.INACTIVE,), LifecycleState.UNCONFIGURED, self.on_cleanup
        )

    def shutdown(self) -> bool:
        with self._lock:
            if self._state is LifecycleState.ACTIVE:
                self.on_deactivate()
            if self._state in (LifecycleState.ACTIVE, LifecycleState.INACTIVE):
                self.on_cleanup()
            ok = bool(self.on_shutdown())
            self._state = LifecycleState.FINALIZED
            return ok

    # subclass hooks
    def on_configure(self) -> bool:
        return True

    def on_activate(self) -> bool:
        return True

    def on_deactivate(self) -> bool:
        return True

    def on_cleanup(self) -> bool:
        return True

    def on_shutdown(self) -> bool:
        return True
