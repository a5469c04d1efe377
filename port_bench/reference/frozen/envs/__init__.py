from .legged_env import EnvState, LeggedEnv, WorldState, make_legged_env  # noqa: F401
