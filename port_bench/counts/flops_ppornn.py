"""Network FLOPs of one PPO-RNN iteration (2 per multiply-add; elementwise
work and physics left out: a lower bound). A GRU cell step is 3 H (O + H)
multiply-adds; the heads read [gru_out, obs]. Rollout: both cells and
both heads on every env step, and once more for the bootstrap. Update:
every minibatch replays its envs' whole sequences (N // M envs a
minibatch, the rest dropped), then per replayed step the weight gradients
of every layer, the heads' input gradients but for their observation
columns, and each cell's recurrent gradient through W_hh."""
from . import macs


def flops_per_iteration(cell) -> float:
    c = cell["cfg"]
    O, A, h, H = (c["num_observations"], c["num_actions"], c["hidden"],
                  c["rnn_hidden_dim"])
    N, T, M = c["num_envs"], c["num_steps"], c["num_minibatches"]
    gru = 3 * H * (O + H)
    act, cri = [O + H, *h, A], [O + H, *h, 1]
    fwd = 2 * gru + macs(act) + macs(cri)
    rollout = T * N * fwd + N * fwd
    d_x = ((macs(act) - (O + H) * act[1]) + H * act[1]
           + (macs(cri) - (O + H) * cri[1]) + H * cri[1] + 2 * 3 * H * H)
    per = 2 * fwd + d_x
    update = c["update_epochs"] * (N // M) * M * T * per
    return 2.0 * (rollout + update)
