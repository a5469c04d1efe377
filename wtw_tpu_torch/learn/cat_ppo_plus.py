"""PPO+ with Constraints-as-Terminations: PPO with a learned Q(s, a) head
and gradient-free action improvement (port of
`wtw_tpu/learn/cat_ppo_plus.py`, reference algos/PPO_plus.py:69-410).

- a Q network over [obs, action] (the `hidden` widths, ELU, orthogonal
  init, out gain 1.0; :94-103);
- during the rollout each sampled action is refined by
  `num_improvement_steps` rounds of smoothed zeroth-order ascent on Q,
  a += alpha / (Np sigma) * sum_p Q(s, a + eps_p) eps_p with
  eps_p ~ N(0, sigma^2), the Np perturbations evaluated as one
  (Np N)-row batch (:237-265); the log-prob is then recomputed for the
  improved action under the current policy (:266);
- Q is trained on the value-normalized returns beside the clipped value
  loss, under `vf_coef` (:374-378).

Everything else is the CaT PPO learner of `cat_ppo.py`. As in the JAX
learner, `std_floor` is not applied and the rollout reports only the mean
step reward.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .cat_ppo import CatAgent, CatPPO, CatPPOArgs, _mlp


@dataclass(frozen=True)
class PPOPlusArgs(CatPPOArgs):
    # action-improvement hyperparameters (algos/PPO_plus.py:186-191)
    n_perturbations: int = 10
    sigma: float = 0.1
    alpha: float = 0.1
    num_improvement_steps: int = 1


class PlusAgent(CatAgent):
    """The CaT agent and a Q head over [obs, action]."""

    def __init__(self, num_obs: int, num_actions: int, hidden=(512, 256, 128),
                 generator: Optional[torch.Generator] = None):
        super().__init__(num_obs, num_actions, hidden, generator)
        self.q_net = _mlp([num_obs + num_actions] + list(hidden) + [1], 1.0,
                          generator)

    def q_value(self, obs: torch.Tensor, actions: torch.Tensor):
        return self.q_net(torch.cat([obs, actions], dim=-1))[..., 0]


def improve_actions(agent: PlusAgent, obs, actions, noise,
                    args: PPOPlusArgs):
    """Zeroth-order refinement on Q (algos/PPO_plus.py:237-265). `noise`:
    standard normal draws (num_improvement_steps, Np, N, A)."""
    Np = args.n_perturbations
    obs_p = obs.expand((Np,) + obs.shape)
    for eps in noise:
        eps = args.sigma * eps                               # (Np, N, A)
        q = agent.q_value(obs_p, actions[None] + eps)       # (Np, N)
        actions = actions + (args.alpha / (Np * args.sigma)
                             * torch.einsum("pn,pna->na", q, eps))
    return actions


class CatPPOPlus(CatPPO):
    """The CaT learner with the Q head (the JAX PlusTrainState)."""

    LOSS_KEYS = ("loss", "pg_loss", "value_loss", "q_loss")
    APPLIES_STD_FLOOR = False
    GROUP_MOMENTS = False

    def make_agent(self, generator):
        return PlusAgent(self.env.num_obs, self.env.num_actions,
                         self.args.hidden, generator=generator)

    def act(self, t, obs_norm, noise=None, improve_noise=None):
        """Sample, improve on Q, then the improved action's log-prob under
        the current policy. `improve_noise` (T, rounds, Np, N, A) replaces
        the drawn perturbations; the draws follow the JAX order (the action
        noise, then each round's perturbations)."""
        args, agent = self.args, self.agent
        mean = agent.actor_mean(obs_norm)
        actions = self.sample(t, mean, noise)
        imp = (improve_noise[t] if improve_noise is not None else torch.randn(
            (args.num_improvement_steps, args.n_perturbations)
            + tuple(mean.shape), generator=self.gen, device=mean.device))
        actions = improve_actions(agent, obs_norm, actions, imp, args)
        return actions, agent.log_prob(mean, actions), agent.value(obs_norm)

    def loss(self, batch, value_rms):
        """CaT PPO's loss with 0.5 mean (Q - ret_n)^2 beside the value loss
        (:374-375); -> (loss, pg, v, q)."""
        loss, pg_loss, v_loss = super().loss(batch, value_rms)
        obs, actions, ret_n = batch[0], batch[1], batch[4]
        q_loss = 0.5 * ((self.agent.q_value(obs, actions) - ret_n) ** 2).mean()
        return loss + self.args.vf_coef * q_loss, pg_loss, v_loss, q_loss

    def train_iteration(self, world, obs_norm, noise=None, perms=None,
                        improve_noise=None):
        """Rollout + update; -> (world, next normalized obs, stats): the
        losses, q_loss, lr and the mean step reward, as the JAX learner."""
        world, obs_norm, traj, metrics = self.rollout(
            world, obs_norm, noise, improve_noise=improve_noise)
        stats = self.update(traj, obs_norm, perms)
        stats["mean_step_reward"] = metrics["mean_step_reward"]
        return world, obs_norm, stats
