"""Walk-These-Ways actor-critic with the concurrent-state-estimation
adaptation module (port of `wtw_tpu/models/actor_critic.py`; reference
go1_gym_learn/ppo_cse/actor_critic.py:19-147), fp32.

- adaptation module: obs_history -> predicted privileged obs (256-128, ELU)
- actor: [obs_history, latent] -> action mean (512-256-128)
- critic: [obs_history, privileged_obs] -> value (512-256-128)
- a learned per-dim std parameter (init 1.0)

Layers are `nn.Sequential(Linear, ELU, ..., Linear)`; weights start
uniform in ±1/sqrt(fan_in), drawn from an explicit generator.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class ACArgs:
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    adaptation_hidden_dims: Tuple[int, ...] = (256, 128)
    activation: str = "elu"


_ACT = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh, "selu": nn.SELU,
        "lrelu": nn.LeakyReLU, "sigmoid": nn.Sigmoid}


def _mlp(sizes, activation: str) -> nn.Sequential:
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(nn.Linear(sizes[i], sizes[i + 1]))
        if i < len(sizes) - 2:
            layers.append(_ACT[activation]())
    return nn.Sequential(*layers)


def init_uniform_(module: nn.Module,
                  generator: Optional[torch.Generator] = None):
    """Every Linear's weight and bias uniform in +-1/sqrt(fan_in)
    (torch.nn.Linear's default, `_init_mlp` of the JAX package)."""
    with torch.no_grad():
        for lin in module.modules():
            if isinstance(lin, nn.Linear):
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    p.copy_(torch.rand(p.shape, generator=generator)
                            * (2 * bound) - bound)


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int,
                 num_obs_history: int, num_actions: int,
                 args: ACArgs = ACArgs(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, P = num_obs_history, num_privileged_obs
        self.adaptation = _mlp((H,) + tuple(args.adaptation_hidden_dims)
                               + (P,), args.activation)
        self.actor = _mlp((H + P,) + tuple(args.actor_hidden_dims)
                          + (num_actions,), args.activation)
        self.critic = _mlp((H + P,) + tuple(args.critic_hidden_dims) + (1,),
                           args.activation)
        self.std = nn.Parameter(args.init_noise_std * torch.ones(num_actions))
        init_uniform_(self, generator)

    def adaptation_module(self, obs_history):
        return self.adaptation(obs_history)

    def actor_mean(self, obs_history, latent):
        return self.actor(torch.cat([obs_history, latent], dim=-1))

    def evaluate(self, obs_history, privileged_obs):
        return self.critic(torch.cat([obs_history, privileged_obs],
                                     dim=-1))[..., 0]

    def act_student(self, obs_history):
        """Deployment-path inference (actor_critic.py:131-135)."""
        latent = self.adaptation_module(obs_history)
        return self.actor_mean(obs_history, latent), latent

    def distribution(self, obs_history):
        """(mean, std) of the Gaussian policy (update_distribution :113-116)."""
        mean, _ = self.act_student(obs_history)
        return mean, self.std.expand_as(mean)


def sample_actions(mean, std, generator: Optional[torch.Generator] = None):
    return mean + std * torch.randn(mean.shape, generator=generator,
                                    device=mean.device)


def log_prob(mean, std, actions):
    var = std ** 2
    lp = -0.5 * ((actions - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return lp.sum(-1)


def entropy(std):
    return (0.5 * torch.log(2 * math.pi * math.e * std ** 2)).sum(-1)
