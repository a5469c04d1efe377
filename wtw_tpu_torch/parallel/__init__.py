"""Env-sharded data-parallel training over `torch.distributed` (port of
`wtw_tpu/parallel`)."""
from .mesh import (all_max, all_mean, all_sum, init_group,  # noqa: F401
                   make_distributed_cat_train_fn, make_distributed_train_fn,
                   replicate, shard_parkour_world, shard_world)
