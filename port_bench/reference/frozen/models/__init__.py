from .robot import RobotModel, load_robot  # noqa: F401
