"""Network FLOPs of one CaT PPO iteration (2 per multiply-add; elementwise
work and physics left out: a lower bound). Rollout: actor-mean and critic
forwards on every env step, the critic once more for the bootstrap.
Update, per sample and epoch (every sample, `update_epochs` times):
forward, weight gradients of every layer, input gradients of every layer
but the two towers' input layers."""
from . import macs


def flops_per_iteration(cell) -> float:
    c = cell["cfg"]
    O, A, h = c["num_observations"], c["num_actions"], c["hidden"]
    N, T = c["num_envs"], c["num_steps"]
    act, cri = [O, *h, A], [O, *h, 1]
    fwd = macs(act) + macs(cri)
    rollout = T * N * fwd + N * macs(cri)
    d_x = (macs(act) - O * act[1]) + (macs(cri) - O * cri[1])
    per = 2 * fwd + d_x
    mb = T * N // c["num_minibatches"]
    update = c["update_epochs"] * mb * c["num_minibatches"] * per
    return 2.0 * (rollout + update)
