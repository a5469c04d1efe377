from .ppo_cse import PPO, PPOArgs, compute_gae  # noqa: F401
from .runner import Runner, RunnerArgs  # noqa: F401
