"""ROS2 launch file — the reference 5-process topology around this engine.

The reference brings up five processes (reference
launch/mcl_launch.py:60-147): nav2 ``map_server`` + ``lifecycle_manager``
serving the map, a static base_link->laser TF (x = 0.288 =
``lidar_offset_x``), the particle-filter node (started 2 s delayed so the
map service is up), and optional RViz.

The engine's bridge loads the map itself and republishes ``/map``
latched (runtime/ros2_bridge.py — the reference's one-shot GetMap service
hop is a design translation, SURVEY §3.1), so the nav2 pair is not
needed; this launch composes the remaining topology 1:1:

* the bridge node (``python -m monte_carlo_localization_tpu.runtime.ros2_bridge``),
* the same static base_link->laser transform,
* optional ``rviz2`` with this repo's config (rviz/tpu_mcl.rviz —
  the same display set and interaction tools as the reference's).

Launch arguments mirror the reference's (``mcl_launch.py:24-40``):
``map_yaml`` (full path to a map YAML), ``config`` (mcl_config.yaml),
``sim_mode`` (switches the odometry topic to /ego_racecar/odom and
use_sim_time), ``use_rviz``.

Usage (on a machine with ROS2 + rclpy; this repo's engine itself is
ROS-free):

    ros2 launch launch/tpu_mcl_launch.py \\
        map_yaml:=$PWD/maps/sibal1.yaml config:=$PWD/config/mcl_config.yaml

Status: authored against the ROS2 Humble launch API; this development
environment has no ROS2 installation, so the file is validated for
structure only (tests/test_ros2_bridge*.py exercise the bridge against a
stubbed rclpy; no live rclcpp/rclpy interop has executed here).
"""

import sys


def generate_launch_description():
    from launch import LaunchDescription
    from launch.actions import DeclareLaunchArgument, ExecuteProcess
    from launch.conditions import IfCondition
    from launch.substitutions import LaunchConfiguration
    from launch_ros.actions import Node

    map_yaml = LaunchConfiguration("map_yaml")
    config = LaunchConfiguration("config")
    sim_mode = LaunchConfiguration("sim_mode")
    use_rviz = LaunchConfiguration("use_rviz")

    return LaunchDescription(
        [
            DeclareLaunchArgument("map_yaml"),
            DeclareLaunchArgument("config", default_value=""),
            DeclareLaunchArgument("sim_mode", default_value="false"),
            DeclareLaunchArgument("use_rviz", default_value="true"),
            # the particle filter bridge (map served by the node itself —
            # no nav2 map_server/lifecycle_manager needed, hence no 2 s
            # startup delay either)
            ExecuteProcess(
                cmd=[
                    sys.executable, "-m",
                    "monte_carlo_localization_tpu.runtime.ros2_bridge",
                    "--map", map_yaml,
                    "--config", config,
                    "--sim-mode", sim_mode,
                ],
                name="particle_filter",
                output="screen",
            ),
            # static base_link -> laser transform, x matching
            # lidar_offset_x (reference mcl_launch.py:111-121)
            Node(
                package="tf2_ros",
                executable="static_transform_publisher",
                name="particle_filter_static_tf_publisher",
                arguments=[
                    "0.288", "0.0", "0.0", "0.0", "0.0", "0.0",
                    "base_link", "laser",
                ],
                output="screen",
            ),
            Node(
                package="rviz2",
                executable="rviz2",
                name="rviz2",
                arguments=["-d", "rviz/tpu_mcl.rviz"],
                condition=IfCondition(use_rviz),
                output="screen",
            ),
        ]
    )
