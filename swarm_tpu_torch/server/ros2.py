"""Optional ROS 2 (rclpy/DDS) topic layer over the scan bridge
(swarm_tpu/server/ros2.py).

The reference's `udp_bridge.py` is a rclpy node: 751-byte scan packets
become `/agent_N/odom` (nav_msgs/Odometry) + `/agent_N/scan`
(sensor_msgs/LaserScan) publications and `/agent_N/cmd_vel`
(geometry_msgs/Twist) subscriptions are relayed back as CMD1 datagrams
(server_nodes/udp_bridge.py:89-148).

Without rclpy, `server/bridge.py` exposes the same data through plain
callbacks (schema-level parity). This module is the DDS layer: when rclpy
IS importable it spins a real node wiring those callbacks to real topics; without rclpy
it raises a clear error at construction. The message-field logic is
factored into pure functions (`odom_msg_fields`, `scan_msg_fields`) so
the topic payloads are testable with no DDS stack present.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from swarm_tpu_torch.server.bridge import ScanBridge


def have_rclpy() -> bool:
    try:
        import rclpy  # noqa: F401
        return True
    except ImportError:
        return False


def odom_msg_fields(agent: int, x: float, y: float, yaw: float) -> Dict:
    """nav_msgs/Odometry field values the bridge publishes
    (udp_bridge.py:110-121): pose in `odom`, yaw as the (z, w) quaternion
    components only — the reference sends a yaw-only quaternion."""
    return {
        "frame_id": "odom",
        "child_frame_id": f"agent_{agent}/base_link",
        "topic": f"/agent_{agent}/odom",
        "position": (float(x), float(y), 0.0),
        "orientation": (0.0, 0.0, math.sin(yaw / 2.0),
                        math.cos(yaw / 2.0)),
    }


def scan_msg_fields(agent: int, ranges) -> Dict:
    """sensor_msgs/LaserScan field values (udp_bridge.py:123-138):
    181 beams, -90..+90 deg at 1 deg increments, 2-35 cm per the
    HC-SR04-on-servo geometry scaled to metres by the firmware."""
    return {
        "frame_id": f"agent_{agent}/laser",
        "topic": f"/agent_{agent}/scan",
        "angle_min": ScanBridge.ANGLE_MIN,
        "angle_max": ScanBridge.ANGLE_MIN + 180 * ScanBridge.ANGLE_INC,
        "angle_increment": ScanBridge.ANGLE_INC,
        "range_min": ScanBridge.RANGE_MIN,
        "range_max": ScanBridge.RANGE_MAX,
        "ranges": [float(r) for r in ranges],
    }


class Ros2Bridge:
    """rclpy node publishing the scan bridge's callbacks as real topics.

    Usage (on a machine with ROS 2):
        bridge = ScanBridge(port=8888)
        node = Ros2Bridge(bridge, agents=[1, 2])
        while rclpy.ok():
            bridge.poll()
            node.spin_once()
    """

    def __init__(self, bridge: ScanBridge, agents,
                 node_name: str = "swarm_tpu_torch_bridge"):
        if not have_rclpy():
            raise RuntimeError(
                "rclpy is not installed — the DDS topic layer needs a "
                "ROS 2 environment; use server.bridge.ScanBridge's "
                "callbacks directly (schema-identical payloads)")
        import rclpy
        from geometry_msgs.msg import Twist
        from nav_msgs.msg import Odometry
        from sensor_msgs.msg import LaserScan

        if not rclpy.ok():
            rclpy.init()
        self._rclpy = rclpy
        self._LaserScan = LaserScan
        self._Odometry = Odometry
        self.node = rclpy.create_node(node_name)
        self.bridge = bridge
        self._odom_pub = {}
        self._scan_pub = {}
        self._cmd_sub = {}
        for a in agents:
            self._odom_pub[a] = self.node.create_publisher(
                Odometry, f"/agent_{a}/odom", 10)
            self._scan_pub[a] = self.node.create_publisher(
                LaserScan, f"/agent_{a}/scan", 10)
            self._cmd_sub[a] = self.node.create_subscription(
                Twist, f"/agent_{a}/cmd_vel",
                lambda msg, a=a: self.bridge.send_cmd_vel(
                    a, msg.linear.x, msg.angular.z), 10)
        bridge.on_odom = self._publish_odom
        bridge.on_scan = self._publish_scan

    def _publish_odom(self, agent, x, y, yaw, quat_zw):
        pub = self._odom_pub.get(agent)
        if pub is None:
            return
        f = odom_msg_fields(agent, x, y, yaw)
        msg = self._Odometry()
        msg.header.stamp = self.node.get_clock().now().to_msg()
        msg.header.frame_id = f["frame_id"]
        msg.child_frame_id = f["child_frame_id"]
        (msg.pose.pose.position.x, msg.pose.pose.position.y,
         msg.pose.pose.position.z) = f["position"]
        (msg.pose.pose.orientation.x, msg.pose.pose.orientation.y,
         msg.pose.pose.orientation.z, msg.pose.pose.orientation.w) = \
            f["orientation"]
        pub.publish(msg)

    def _publish_scan(self, agent, ranges):
        pub = self._scan_pub.get(agent)
        if pub is None:
            return
        f = scan_msg_fields(agent, ranges)
        msg = self._LaserScan()
        msg.header.stamp = self.node.get_clock().now().to_msg()
        msg.header.frame_id = f["frame_id"]
        msg.angle_min = f["angle_min"]
        msg.angle_max = f["angle_max"]
        msg.angle_increment = f["angle_increment"]
        msg.range_min = f["range_min"]
        msg.range_max = f["range_max"]
        msg.ranges = f["ranges"]
        pub.publish(msg)

    def spin_once(self, timeout_sec: float = 0.0):
        self._rclpy.spin_once(self.node, timeout_sec=timeout_sec)

    def close(self):
        self.node.destroy_node()
