"""Optional ROS2 bridge — the reference's exact topic surface over MCLNode.

The reference is an rclcpp node wired to /scan, /odom, /initialpose and
/clicked_point in, and /pf/viz/inferred_pose, /pf/viz/particles,
/pf/pose/odom, /map + TF out (reference src/particle_filter.cpp:115-148
pubs/subs, :857-983 outputs, launch/mcl_launch.py topic remaps). This
module reproduces that surface with rclpy around the engine: the
subscriptions feed ``MCLNode.on_scan``/``on_odometry``/initializers, a
wall timer at ``timer_frequency`` drives ``MCLNode.update()`` (reference
:155-159), a 5 Hz timer republishes the map (reference :162-165), and the
publication topics mirror the reference names.

rclpy is NOT a dependency of this package — the bridge imports it lazily
and raises a clear error when absent (SURVEY §7 keeps the ROS2 bridge
optional; every capability is available ROS-free through MCLNode + sinks).

The message-filling helpers below are pure functions over duck-typed
message objects so they are unit-testable without ROS installed.
"""

from __future__ import annotations

import numpy as np

from monte_carlo_localization_tpu.config import MCLConfig
from monte_carlo_localization_tpu.mapping.grid_map import GridMap
from monte_carlo_localization_tpu.runtime.node import MCLNode
from monte_carlo_localization_tpu.utils.geometry import (
    quaternion_to_yaw,
    yaw_to_quaternion,
)

MAP_FRAME = "map"
BASE_FRAME = "base_link"


# ----- pure message fillers (duck-typed; unit-testable without rclpy) -----

def fill_pose(msg_pose, pose) -> None:
    """Populate a geometry_msgs/Pose from [x, y, theta]."""
    x, y, th = (float(v) for v in np.asarray(pose)[:3])
    msg_pose.position.x = x
    msg_pose.position.y = y
    msg_pose.position.z = 0.0
    qx, qy, qz, qw = yaw_to_quaternion(th)
    msg_pose.orientation.x = qx
    msg_pose.orientation.y = qy
    msg_pose.orientation.z = qz
    msg_pose.orientation.w = qw


def pose_from_msg(msg_pose) -> np.ndarray:
    """[x, y, theta] from a geometry_msgs/Pose."""
    o = msg_pose.orientation
    return np.array(
        [
            float(msg_pose.position.x),
            float(msg_pose.position.y),
            quaternion_to_yaw(o.x, o.y, o.z, o.w),
        ]
    )


def fill_pose_array(msg, particles) -> None:
    """Populate a geometry_msgs/PoseArray from an (N, 3) cloud; ``msg.poses``
    must already hold N pose messages (the bridge preallocates them)."""
    particles = np.asarray(particles)
    for p, m in zip(particles, msg.poses):
        fill_pose(m, p)


def fill_odometry(msg, pose, velocity, angular_velocity) -> None:
    """Populate a nav_msgs/Odometry (reference publish_tf :868-886)."""
    fill_pose(msg.pose.pose, pose)
    msg.twist.twist.linear.x = float(velocity)
    msg.twist.twist.angular.z = float(angular_velocity)


def fill_transform(msg, pose) -> None:
    """Populate a geometry_msgs/Transform from [x, y, theta]."""
    x, y, th = (float(v) for v in np.asarray(pose)[:3])
    msg.translation.x = x
    msg.translation.y = y
    msg.translation.z = 0.0
    qx, qy, qz, qw = yaw_to_quaternion(th)
    msg.rotation.x = qx
    msg.rotation.y = qy
    msg.rotation.z = qz
    msg.rotation.w = qw


def fill_occupancy_grid(msg, gm: GridMap) -> None:
    """Populate a nav_msgs/OccupancyGrid from the engine's map (the inverse
    of the reference's get_omap ingestion, :190-213)."""
    occ = np.asarray(gm.occupancy)
    h, w = occ.shape
    msg.info.resolution = float(gm.resolution)
    msg.info.width = int(w)
    msg.info.height = int(h)
    msg.info.origin.position.x = float(gm.origin_x)
    msg.info.origin.position.y = float(gm.origin_y)
    qx, qy, qz, qw = yaw_to_quaternion(float(gm.origin_yaw))
    msg.info.origin.orientation.x = qx
    msg.info.origin.orientation.y = qy
    msg.info.origin.orientation.z = qz
    msg.info.origin.orientation.w = qw
    msg.data = occ.reshape(-1).astype(np.int8).tolist()


def scan_to_arrays(msg) -> tuple[np.ndarray, float, float]:
    """(ranges, angle_min, angle_increment) from a sensor_msgs/LaserScan."""
    return (
        np.asarray(msg.ranges, dtype=np.float32),
        float(msg.angle_min),
        float(msg.angle_increment),
    )


def odom_to_args(msg) -> tuple[float, float, float, float, float]:
    """(x, y, theta, v, omega) from a nav_msgs/Odometry (reference
    odomCB :325-352: pose from msg.pose, twist linear.x/angular.z)."""
    pose = pose_from_msg(msg.pose.pose)
    return (
        float(pose[0]),
        float(pose[1]),
        float(pose[2]),
        float(msg.twist.twist.linear.x),
        float(msg.twist.twist.angular.z),
    )


# ----- the bridge proper (requires rclpy at runtime) -----

class ROS2Bridge:
    """rclpy node wrapping :class:`MCLNode` with the reference's topics.

    Usage::

        import rclpy
        rclpy.init()
        bridge = ROS2Bridge(grid_map, config, sim_mode=False)
        rclpy.spin(bridge.ros_node)
    """

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        sim_mode: bool = False,
        node_name: str = "particle_filter",
    ):
        try:
            import rclpy  # noqa: F401
            from rclpy.node import Node
        except ImportError as e:  # pragma: no cover - exercised without ROS
            raise ImportError(
                "ROS2Bridge needs rclpy (a ROS2 environment). The engine "
                "itself is ROS-free: use runtime.MCLNode with sinks instead."
            ) from e

        from geometry_msgs.msg import (
            PointStamped,
            PoseArray,
            PoseStamped,
            PoseWithCovarianceStamped,
            TransformStamped,
        )
        from nav_msgs.msg import OccupancyGrid, Odometry
        from sensor_msgs.msg import LaserScan
        from tf2_ros import TransformBroadcaster

        self.config = config or MCLConfig()
        self.node = MCLNode(grid_map, self.config)
        self.ros_node = Node(node_name)
        self._map_msg = None  # OccupancyGrid built once, stamped per tick
        self._msg = dict(
            PoseStamped=PoseStamped,
            PoseArray=PoseArray,
            Odometry=Odometry,
            OccupancyGrid=OccupancyGrid,
            TransformStamped=TransformStamped,
        )

        # publications (reference :115-130)
        qos_latched = 1  # depth; latching handled by transient_local below
        from rclpy.qos import (
            DurabilityPolicy,
            QoSProfile,
        )

        latched = QoSProfile(
            depth=qos_latched,
            durability=DurabilityPolicy.TRANSIENT_LOCAL,
        )
        n = self.ros_node
        self.pub_pose = n.create_publisher(PoseStamped, "/pf/viz/inferred_pose", 10)
        self.pub_particles = n.create_publisher(PoseArray, "/pf/viz/particles", 10)
        self.pub_odom = n.create_publisher(Odometry, "/pf/pose/odom", 10)
        self.pub_map = n.create_publisher(OccupancyGrid, "/map", latched)
        self.tf_broadcaster = TransformBroadcaster(n)

        # subscriptions (reference :133-145; sim_mode switches the odom
        # topic, launch/mcl_launch.py:47-59)
        odom_topic = "/ego_racecar/odom" if sim_mode else self.config.odom_topic
        n.create_subscription(LaserScan, self.config.scan_topic, self._on_scan, 10)
        n.create_subscription(Odometry, odom_topic, self._on_odom, 10)
        n.create_subscription(
            PoseWithCovarianceStamped, "/initialpose", self._on_initialpose, 10
        )
        n.create_subscription(PointStamped, "/clicked_point", self._on_clicked, 10)

        # timers (reference :154-165)
        n.create_timer(1.0 / self.config.timer_frequency, self._on_timer)
        n.create_timer(0.2, self._publish_map)
        self._publish_map()

    # -- callbacks --
    def _now(self) -> float:
        t = self.ros_node.get_clock().now().seconds_nanoseconds()
        return t[0] + t[1] * 1e-9

    def _stamp(self):
        return self.ros_node.get_clock().now().to_msg()

    def _on_scan(self, msg) -> None:
        ranges, amin, ainc = scan_to_arrays(msg)
        self.node.on_scan(ranges, angle_min=amin, angle_increment=ainc)

    def _on_odom(self, msg) -> None:
        self.node.on_odometry(*odom_to_args(msg))

    def _on_initialpose(self, msg) -> None:
        self.node.initialize_pose(pose_from_msg(msg.pose.pose))

    def _on_clicked(self, msg) -> None:
        self.node.initialize_global()

    def _on_timer(self) -> None:
        pose = self.node.update(now=self._now())
        self._publish_tf()
        if pose is not None:
            self._publish_correction(pose)

    # -- outputs (reference :857-983) --
    def _publish_tf(self) -> None:
        TransformStamped = self._msg["TransformStamped"]
        t = TransformStamped()
        t.header.stamp = self._stamp()
        t.header.frame_id = MAP_FRAME
        t.child_frame_id = BASE_FRAME
        fill_transform(t.transform, self.node.base_link_pose())
        self.tf_broadcaster.sendTransform(t)
        if self.config.publish_odom:
            om = self._msg["Odometry"]()
            om.header.stamp = t.header.stamp
            om.header.frame_id = MAP_FRAME
            om.child_frame_id = BASE_FRAME
            snap = self.node.tracker.snapshot()
            fill_odometry(
                om, self.node.base_link_pose(), snap.velocity,
                snap.angular_velocity,
            )
            self.pub_odom.publish(om)

    def _publish_correction(self, pose) -> None:
        if not self.config.viz:
            return
        ps = self._msg["PoseStamped"]()
        ps.header.stamp = self._stamp()
        ps.header.frame_id = MAP_FRAME
        fill_pose(ps.pose, pose)
        self.pub_pose.publish(ps)

        cloud = self.node.particle_cloud()
        pa = self._msg["PoseArray"]()
        pa.header.stamp = ps.header.stamp
        pa.header.frame_id = MAP_FRAME
        from geometry_msgs.msg import Pose as _Pose

        pa.poses = [_Pose() for _ in range(len(cloud))]
        fill_pose_array(pa, cloud)
        self.pub_particles.publish(pa)

    def _publish_map(self) -> None:
        # the grid payload is filled ONCE and cached: rebuilding the data
        # list per 5 Hz tick converts millions of cells on the executor
        # thread for big maps (Spielberg: ~4M), starving the MCL timer and
        # scan/odom callbacks; only the stamp is refreshed per republish
        og = self._map_msg
        if og is None:
            og = self._msg["OccupancyGrid"]()
            og.header.frame_id = MAP_FRAME
            fill_occupancy_grid(og, self.node.map)
            self._map_msg = og
        og.header.stamp = self._stamp()
        self.pub_map.publish(og)


def main(args=None):  # pragma: no cover - needs a ROS2 environment
    """Entry point mirroring the reference's node executable."""
    import argparse

    import rclpy

    from monte_carlo_localization_tpu.config import load_config
    from monte_carlo_localization_tpu.mapping import load_map

    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True)
    ap.add_argument("--config", default=None)
    # flag alone = true; an explicit value ("true"/"false") lets launch
    # files pass a LaunchConfiguration through (launch/tpu_mcl_launch.py)
    ap.add_argument("--sim-mode", nargs="?", const="true", default="false")
    ns = ap.parse_args(args)
    sim = str(ns.sim_mode).lower() in ("1", "true", "yes")

    cfg = load_config(ns.config) if ns.config else MCLConfig()
    gm = load_map(ns.map)
    rclpy.init()
    bridge = ROS2Bridge(gm, cfg, sim_mode=sim)
    rclpy.spin(bridge.ros_node)
