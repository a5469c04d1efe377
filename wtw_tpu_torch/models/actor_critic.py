"""Walk-These-Ways actor-critic with the concurrent-state-estimation
adaptation module (port of `wtw_tpu/models/actor_critic.py`; reference
go1_gym_learn/ppo_cse/actor_critic.py:19-147).

- adaptation module: obs_history -> predicted privileged obs (256-128, ELU)
- actor: [obs_history, latent] -> action mean (512-256-128)
- critic: [obs_history, privileged_obs] -> value (512-256-128)
- a learned per-dim std parameter (init 1.0)

Layers are `nn.Sequential(Linear, ELU, ..., Linear)`; weights start
uniform in ±1/sqrt(fan_in), drawn from an explicit generator.

`ACArgs.compute_dtype="bfloat16"` follows the JAX package's mixed
precision (`_matmul`, `_apply_mlp`, `_apply_mlp_parts` there): every GEMM
takes bf16 inputs and accumulates in fp32; a hidden layer's product is
rounded to bf16 and its bias add and activation run in bf16; a tower's
output layer gives an fp32 product plus the fp32 bias. The first layer of
a tower over a concatenated input is a sum of per-part products, each
rounded to bf16 before it is added (bias first, then the parts in order),
as JAX adds them. Parameters stay fp32; the forward casts them. In
"float32" the towers run as plain `nn.Sequential`s.
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
    # GEMM input dtype, "float32" or "bfloat16" (see the module docstring)
    compute_dtype: str = "float32"


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


def _matmul(x, w, dtype: str, out_dtype=None):
    """x @ w.T for a Linear weight w (out, in): `dtype` inputs with fp32
    accumulation and an `out_dtype` result (None: fp32). A bf16 x bf16
    product with an fp32 result is taken on the bf16-rounded inputs in
    fp32: each product is exact there and the sum accumulates in fp32."""
    if dtype == "float32":
        return x.float() @ w.t()
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if out_dtype == torch.bfloat16:
        return xb @ wb.t()
    return xb.float() @ wb.float().t()


def _linears(seq: nn.Sequential):
    return [m for m in seq if isinstance(m, nn.Linear)]


def _apply_tail(seq: nn.Sequential, x, dtype: str, hid):
    """seq's Linear layers after the first, on the activated first-layer
    output (`_apply_tail` of the JAX package)."""
    lins = _linears(seq)
    for i in range(1, len(lins)):
        last = i == len(lins) - 1
        o = None if (last or hid is None) else hid
        b = lins[i].bias if o is None else lins[i].bias.to(o)
        x = _matmul(x, lins[i].weight, dtype, o) + b
        if not last:
            x = seq[2 * i + 1](x)
    return x


def _apply_mlp(seq: nn.Sequential, x, dtype: str = "float32"):
    if dtype == "float32":
        return seq(x)
    hid = torch.bfloat16
    lin = _linears(seq)[0]
    o = hid if len(seq) > 1 else None
    x = _matmul(x, lin.weight, dtype, o) + (lin.bias if o is None
                                            else lin.bias.to(o))
    if len(seq) > 1:
        x = seq[1](x)
    return _apply_tail(seq, x, dtype, hid)


def _apply_mlp_parts(seq: nn.Sequential, parts, dtype: str = "float32"):
    """`seq` on the concatenation of `parts`, its first layer a sum of
    per-part products against row blocks of the weight: the bias, then
    each part's product added in order (in bf16 each product is rounded
    to bf16 before the add, as the JAX package does)."""
    lins = _linears(seq)
    hid = None if dtype == "float32" or len(lins) == 1 else torch.bfloat16
    w0 = lins[0].weight
    x = lins[0].bias if hid is None else lins[0].bias.to(hid)
    off = 0
    for p in parts:
        d = p.shape[-1]
        x = x + _matmul(p, w0[:, off:off + d], dtype, hid)
        off += d
    assert off == w0.shape[1], (off, w0.shape)
    if len(lins) > 1:
        x = seq[1](x)
    return _apply_tail(seq, x, dtype, hid)


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
        if args.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {args.compute_dtype!r}: "
                             f"'float32' or 'bfloat16'")
        self.compute_dtype = args.compute_dtype
        init_uniform_(self, generator)

    def adaptation_module(self, obs_history):
        return _apply_mlp(self.adaptation, obs_history, self.compute_dtype)

    def actor_mean(self, obs_history, latent):
        if self.compute_dtype == "float32":
            return self.actor(torch.cat([obs_history, latent], dim=-1))
        return _apply_mlp_parts(self.actor, [obs_history, latent],
                                self.compute_dtype)

    def evaluate(self, obs_history, privileged_obs):
        if self.compute_dtype == "float32":
            return self.critic(torch.cat([obs_history, privileged_obs],
                                         dim=-1))[..., 0]
        return _apply_mlp_parts(self.critic, [obs_history, privileged_obs],
                                self.compute_dtype)[..., 0]

    def actor_critic_heads(self, obs_history, latent, privileged_obs):
        """(actor mean, value) with the two first layers' products over the
        shared obs_history taken as one GEMM against both weights' history
        columns (`actor_critic_heads` of the JAX package: its bias, then the
        shared product's slice, then the latent or privileged part, in
        JAX's order of additions)."""
        dtype = self.compute_dtype
        hid = None if dtype == "float32" else torch.bfloat16
        cast = (lambda b: b) if hid is None else (lambda b: b.to(hid))
        a, c = _linears(self.actor)[0], _linears(self.critic)[0]
        H = obs_history.shape[-1]
        w_cat = torch.cat([a.weight[:, :H], c.weight[:, :H]], dim=0)
        y = _matmul(obs_history, w_cat, dtype, hid)
        da = a.weight.shape[0]
        y_a = (y[..., :da] + cast(a.bias)
               + _matmul(latent, a.weight[:, H:], dtype, hid))
        y_c = (y[..., da:] + cast(c.bias)
               + _matmul(privileged_obs, c.weight[:, H:], dtype, hid))
        za = _apply_tail(self.actor, self.actor[1](y_a), dtype, hid)
        zc = _apply_tail(self.critic, self.critic[1](y_c), dtype, hid)
        return za, zc[..., 0]

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
