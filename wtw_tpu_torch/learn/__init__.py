from .cat_ppo import CatPPO, CatPPOArgs  # noqa: F401
from .cat_ppo_plus import CatPPOPlus, PPOPlusArgs  # noqa: F401
from .cat_ppornn import CatPPORNN, RNNArgs  # noqa: F401
from .pbt import PBTArgs, Population, exploit_explore, train_pbt  # noqa: F401
from .ppo_cse import PPO, PPOArgs, compute_gae  # noqa: F401
from .ppo_rma import RMA, RMAArgs  # noqa: F401
from .runner import RMARunner, Runner, RunnerArgs  # noqa: F401
