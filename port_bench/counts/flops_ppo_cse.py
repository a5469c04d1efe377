"""Network FLOPs of one `ppo_cse` iteration (2 per multiply-add; the
elementwise work and the physics are left out, so a share of a peak
built on this is a lower bound). Rollout: adaptation, actor and critic
forwards on every env step, and the critic once more for the bootstrap.
Update, per sample and epoch: the PPO loss's forward, the weight
gradients of every layer, the input gradients of every layer but the
towers' input layers (the actor's first layer does take one for its
latent columns, which feed the adaptation module), then the adaptation
substep's forward and backward."""
from . import macs


def flops_per_iteration(cell) -> float:
    c = cell["cfg"]
    H = c["num_observations"] * c["num_observation_history"]
    P, A = c["num_privileged_obs"], c["num_actions"]
    N, T = c["num_envs"], c["num_steps_per_env"]
    ad = [H, *c["adaptation_hidden_dims"], P]
    act = [H + P, *c["actor_hidden_dims"], A]
    cri = [H + P, *c["critic_hidden_dims"], 1]
    fwd = macs(ad) + macs(act) + macs(cri)
    rollout = T * N * fwd + N * macs(cri)
    d_x = ((macs(ad) - H * ad[1]) + (macs(act) - (H + P) * act[1])
           + P * act[1] + (macs(cri) - (H + P) * cri[1]))
    substep = 2 * macs(ad) + (macs(ad) - H * ad[1])
    update = c["num_learning_epochs"] * T * N * (2 * fwd + d_x + substep)
    return 2.0 * (rollout + update)
