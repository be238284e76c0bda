"""Composable-node container.

Equivalent of the reference's ``ComposableNodeContainer`` hosting the
``RPlidarNode`` plugin (launch/composition.launch.py:62-78): several nodes
share one process and one :class:`IntraProcessBus`, so consumers in the same
container receive scans without copies.  Unlike the reference's composition
launch (which emits no lifecycle transitions — launch/composition.launch.py:44-47),
bringup here is explicit via :meth:`configure_all` / :meth:`activate_all`.
"""

from __future__ import annotations

from typing import Optional

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.launch.bus import BusPublisher, IntraProcessBus
from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode


class NodeContainer:
    def __init__(self) -> None:
        self.bus = IntraProcessBus()
        self.nodes: dict[str, RPlidarNode] = {}

    def add_node(
        self,
        name: str,
        params: Optional[DriverParams] = None,
        *,
        namespace: Optional[str] = None,
        **node_kwargs,
    ) -> RPlidarNode:
        if name in self.nodes:
            raise ValueError(f"node {name!r} already loaded")
        ns = namespace if namespace is not None else f"/{name}"
        node = RPlidarNode(
            params,
            BusPublisher(self.bus, ns),
            name=name,
            **node_kwargs,
        )
        self.nodes[name] = node
        return node

    def unload_node(self, name: str) -> None:
        node = self.nodes.pop(name)
        if node.lifecycle_state is LifecycleState.ACTIVE:
            node.deactivate()
        if node.lifecycle_state is LifecycleState.INACTIVE:
            node.cleanup()
        node.shutdown()

    def configure_all(self) -> bool:
        return all(n.configure() for n in self.nodes.values())

    def activate_all(self) -> bool:
        return all(n.activate() for n in self.nodes.values())

    def shutdown_all(self) -> None:
        for name in list(self.nodes):
            self.unload_node(name)

    def __enter__(self) -> "NodeContainer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown_all()
