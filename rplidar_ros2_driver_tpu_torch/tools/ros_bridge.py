"""Optional rclpy bridge: PublisherBase -> real ROS 2 topics.

The node's publishing seam (node/publisher.py) is ROS-free by design;
this module is the deployment adapter for hosts that DO have ROS 2:
it maps the host message types onto ``sensor_msgs/LaserScan``,
``sensor_msgs/PointCloud2`` (xy float32 fields), ``tf2_msgs``
static transforms, and ``diagnostic_msgs/DiagnosticArray`` — the exact
four topics the reference node publishes (src/rplidar_node.cpp:154-208,
490-545, 558-683) — with the same QoS vocabulary (``reliable`` /
``best_effort``, keep-last depth 10, volatile durability; static TF
latched via transient-local, matching tf2_ros::StaticTransformBroadcaster).

rclpy is not a dependency of this package (and is absent from CI, which
is why this module carries no tests beyond import gating): everything
ROS touches is inside ``RclpyPublisher``, constructed only when rclpy
imports.  Field mapping is deliberately 1:1 with messages.py — no
computation happens here.

Usage on a ROS 2 host:

    import rclpy
    from rplidar_ros2_driver_tpu_torch import RPlidarNode, DriverParams
    from rplidar_ros2_driver_tpu_torch.tools.ros_bridge import RclpyPublisher

    rclpy.init()
    pub = RclpyPublisher(qos_reliability="best_effort")
    node = RPlidarNode(DriverParams(), publisher=pub)
    node.configure(); node.activate()
    rclpy.spin(pub.ros_node)
"""

from __future__ import annotations

from rplidar_ros2_driver_tpu_torch.node.messages import (
    DiagnosticStatus,
    LaserScanHost,
    PointCloudHost,
    StaticTransform,
)
from rplidar_ros2_driver_tpu_torch.node.publisher import PublisherBase


def rclpy_available() -> bool:
    """True only when EVERYTHING the publisher constructs is importable —
    rclpy plus the four message packages — so the graceful-degradation
    gate cannot pass on a partially-sourced ROS overlay that would still
    crash construction."""
    try:
        import builtin_interfaces.msg  # noqa: F401
        import diagnostic_msgs.msg  # noqa: F401
        import geometry_msgs.msg  # noqa: F401
        import rclpy  # noqa: F401
        import sensor_msgs.msg  # noqa: F401
        import tf2_msgs.msg  # noqa: F401

        return True
    except ImportError:
        return False


class RclpyPublisher(PublisherBase):
    """Publishes the host messages on real ROS 2 topics.

    Raises ImportError at construction when rclpy is absent — callers
    that want graceful degradation check :func:`rclpy_available` first
    (the in-memory CollectingPublisher is the no-ROS default).
    """

    def __init__(
        self,
        node_name: str = "rplidar_node",
        *,
        qos_reliability: str = "best_effort",
        scan_topic: str = "scan",
        cloud_topic: str = "points",
    ) -> None:
        if qos_reliability not in ("reliable", "best_effort"):
            raise ValueError(
                f"qos_reliability must be 'reliable' or 'best_effort', "
                f"got {qos_reliability!r}"
            )
        # import EVERYTHING the publish methods will touch, so a
        # partially-sourced ROS overlay fails loudly here (matching the
        # rclpy_available() gate) instead of on the scan thread at the
        # first publish
        import builtin_interfaces.msg  # noqa: F401
        import geometry_msgs.msg  # noqa: F401
        import rclpy.node
        from diagnostic_msgs.msg import DiagnosticArray
        from rclpy.qos import (
            QoSDurabilityPolicy,
            QoSProfile,
            QoSReliabilityPolicy,
        )
        from sensor_msgs.msg import LaserScan, PointCloud2
        from tf2_msgs.msg import TFMessage

        self.ros_node = rclpy.node.Node(node_name)
        qos = QoSProfile(
            depth=10,
            reliability=(
                QoSReliabilityPolicy.RELIABLE
                if qos_reliability == "reliable"
                else QoSReliabilityPolicy.BEST_EFFORT
            ),
        )
        latched = QoSProfile(
            depth=1, durability=QoSDurabilityPolicy.TRANSIENT_LOCAL
        )
        self._scan_pub = self.ros_node.create_publisher(LaserScan, scan_topic, qos)
        self._cloud_pub = self.ros_node.create_publisher(PointCloud2, cloud_topic, qos)
        self._tf_pub = self.ros_node.create_publisher(TFMessage, "/tf_static", latched)
        self._diag_pub = self.ros_node.create_publisher(
            DiagnosticArray, "/diagnostics", qos
        )
        self.scan_count = 0

    # -- PublisherBase -------------------------------------------------------

    def _stamp(self, t: float):
        from builtin_interfaces.msg import Time

        sec = int(t)
        return Time(sec=sec, nanosec=int((t - sec) * 1e9))

    def publish_scan(self, msg: LaserScanHost) -> None:
        import array

        import numpy as np
        from sensor_msgs.msg import LaserScan

        out = LaserScan()
        out.header.stamp = self._stamp(msg.stamp)
        out.header.frame_id = msg.frame_id
        out.angle_min = float(msg.angle_min)
        out.angle_max = float(msg.angle_max)
        out.angle_increment = float(msg.angle_increment)
        out.time_increment = float(msg.time_increment)
        out.scan_time = float(msg.scan_time)
        out.range_min = float(msg.range_min)
        out.range_max = float(msg.range_max)
        # array('f') is rclpy's native float32[] representation — no
        # per-element Python loop on the publish hot path
        out.ranges = array.array("f", np.asarray(msg.ranges, np.float32).tobytes())
        out.intensities = array.array(
            "f", np.asarray(msg.intensities, np.float32).tobytes()
        )
        self._scan_pub.publish(out)
        self.scan_count += 1

    def publish_cloud(self, msg: PointCloudHost) -> None:
        import numpy as np
        from sensor_msgs.msg import PointCloud2, PointField

        xy = np.asarray(msg.points_xy, np.float32)
        out = PointCloud2()
        out.header.stamp = self._stamp(msg.stamp)
        out.header.frame_id = msg.frame_id
        out.height = 1
        out.width = int(xy.shape[0])
        out.fields = [
            PointField(name="x", offset=0, datatype=PointField.FLOAT32, count=1),
            PointField(name="y", offset=4, datatype=PointField.FLOAT32, count=1),
        ]
        out.is_bigendian = False
        out.point_step = 8
        out.row_step = 8 * out.width
        out.data = xy.tobytes()
        out.is_dense = True
        self._cloud_pub.publish(out)

    def publish_tf_static(self, tf: StaticTransform) -> None:
        from geometry_msgs.msg import TransformStamped
        from tf2_msgs.msg import TFMessage

        t = TransformStamped()
        t.header.frame_id = tf.parent
        t.child_frame_id = tf.child
        tx, ty, tz = tf.translation
        t.transform.translation.x = float(tx)
        t.transform.translation.y = float(ty)
        t.transform.translation.z = float(tz)
        w, x, y, z = tf.rotation_wxyz
        t.transform.rotation.w = float(w)
        t.transform.rotation.x = float(x)
        t.transform.rotation.y = float(y)
        t.transform.rotation.z = float(z)
        self._tf_pub.publish(TFMessage(transforms=[t]))

    def publish_diagnostics(self, status: DiagnosticStatus) -> None:
        from diagnostic_msgs.msg import (
            DiagnosticArray,
            DiagnosticStatus as RosDiag,
            KeyValue,
        )

        d = RosDiag()
        d.level = bytes([int(status.level)])
        d.name = status.name
        d.message = status.message
        d.hardware_id = status.hardware_id
        d.values = [KeyValue(key=k, value=v) for k, v in status.values.items()]
        arr = DiagnosticArray()
        arr.header.stamp = self.ros_node.get_clock().now().to_msg()
        arr.status = [d]
        self._diag_pub.publish(arr)
