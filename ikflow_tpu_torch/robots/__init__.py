from ikflow_tpu_torch.robots.chain import Joint, KinematicChain
from ikflow_tpu_torch.robots.library import get_robot, robot_names

__all__ = ["Joint", "KinematicChain", "get_robot", "robot_names"]
