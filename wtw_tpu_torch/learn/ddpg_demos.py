"""DDPG with expert demonstrations and the recurrent depth-vision student
(port of `wtw_tpu/learn/ddpg_demos.py`; reference
algos/DDPG_demos_generate.py and DDPG_demos_rnn_vision.py):

1. `generate_demos`: roll a trained expert and fill a sequence replay
   buffer with its demonstrations (DDPG_demos_generate.py:339-431);
2. `train_vision_student`: train a depth-vision student, a depth CNN
   (conv 16/32/32 + max-pool -> a 128 latent, :297-327), a GRU actor over
   [proprio (45), vision latent (128)] (:363-392) and an ensemble of 10 MLP
   Q-networks with LayerNorm (:343-361); TD3-style clipped-noise targets
   from the min of 2 random target critics (:571-585), CaT-scaled targets
   (1 - p_done) on reward and bootstrap (:585), 50/50 online/expert
   batches (:543-560), the vision latent refreshed every 5 env steps
   (:494-497), depth stored as uint8 (:523-525).

The replay buffer is a fixed-shape ring over (time, env) on the device,
written in place, with windowed sampling and episode-boundary masks. The
critics' weights are stacked, (10, in, out), and run as one batched
product a layer. Every random draw goes through `Draws`, so a test can hand
the port the draws it hands the JAX package.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .cat_ppo import _mlp
from .ppo_cse import clip_by_global_norm_


@dataclass(frozen=True)
class DDPGArgs:
    critic_lr: float = 3e-4
    actor_lr: float = 3e-4
    buffer_steps: int = 512          # ring length in env steps
    learning_starts: int = 64        # env steps before updates
    gamma: float = 0.99
    policy_frequency: int = 2
    tau: float = 0.005
    batch_size: int = 64             # sequences per update (half expert)
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    seq_len: int = 5
    critic_nb: int = 10
    updates_per_step: int = 8
    vis_hw: int = 48
    vision_latent: int = 128
    rnn_hidden: int = 256
    proprio_dim: int = 45
    vision_update_interval: int = 5
    action_low: float = -1.0
    action_high: float = 1.0
    # hold actor (not Q/target) updates for this many env steps after a BC
    # warm start, so the fresh Q ensemble fits the warm-started policy
    # before its gradients steer the actor; ignored when bc_batches == 0
    actor_delay_env_steps: int = 65536


class Draws:
    """The pipeline's random draws, from one torch generator: window starts
    and envs (`randint`), target policy noise (`normal`), the critic pair
    (`permutation`) and warm-up actions (`uniform`)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def randint(self, high: int, n: int) -> torch.Tensor:
        return torch.randint(0, high, (n,), generator=self.gen,
                             device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)

    def uniform(self, shape, low: float, high: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen,
                          device=self.device) * (high - low) + low


# ----------------------------------------------------------------------
# networks
# ----------------------------------------------------------------------
def _leaky(x):
    return F.leaky_relu(x, 0.01)


class VisionNet(nn.Module):
    """DepthOnlyFCBackbone58x87 (:297-327): (B, H, W) depth in [0, 1] ->
    (B, latent). The JAX net flattens NHWC, so the conv output is put in H,
    W, C order before `l1` (whose 1568 inputs follow that order)."""

    def __init__(self, args: DDPGArgs = DDPGArgs(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c1 = nn.Conv2d(1, 16, 5)
        self.c2 = nn.Conv2d(16, 32, 4)
        self.c3 = nn.Conv2d(32, 32, 3)
        self.l1 = _mlp([1568, args.vision_latent], 1.0, generator)[0]
        self.l2 = _mlp([args.vision_latent, args.vision_latent], 1.0,
                       generator)[0]
        with torch.no_grad():           # He normal, zero biases (init_vision)
            for conv, fan in ((self.c1, 25), (self.c2, 16 * 16),
                              (self.c3, 9 * 32)):
                conv.weight.normal_(0.0, math.sqrt(2.0 / fan),
                                    generator=generator)
                conv.bias.zero_()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img[:, None]
        x = F.max_pool2d(_leaky(self.c1(x)), 2)
        x = F.max_pool2d(_leaky(self.c2(x)), 2)
        x = _leaky(self.c3(x))
        x = x.permute(0, 2, 3, 1).flatten(1)
        x = _leaky(self.l1(x))
        return F.elu(self.l2(x))


class Actor(nn.Module):
    """The recurrent student (:363-392): a GRU over [proprio, vision latent]
    and a 512-256-128 ELU head with tanh scaling."""

    def __init__(self, num_actions: int, args: DDPGArgs = DDPGArgs(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        d = args.rnn_hidden
        self.memory = nn.GRUCell(args.vision_latent + args.proprio_dim, d)
        bound = 1.0 / math.sqrt(d)          # init_gru, torch's default
        with torch.no_grad():
            for p in self.memory.parameters():
                p.uniform_(-bound, bound, generator=generator)
        self.head = _mlp([d, 512, 256, 128, num_actions], 1.0, generator)

    def forward(self, proprio, vision_latent, hidden):
        """One step; -> (actions, hidden)."""
        a = self.args
        h = self.memory(torch.cat([proprio, vision_latent], dim=-1), hidden)
        mu = torch.tanh(self.head(h))
        scale = (a.action_high - a.action_low) / 2.0
        bias = (a.action_high + a.action_low) / 2.0
        return mu * scale + bias, h


class Student(nn.Module):
    """The depth student that eval runs: the actor and the vision net (the
    JAX student file's {"actor", "vision"})."""

    def __init__(self, num_actions: int, args: DDPGArgs = DDPGArgs(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vision = VisionNet(args, generator)
        self.actor = Actor(num_actions, args, generator)


Q_SIZES = (512, 256, 128, 1)


class QEnsemble(nn.Module):
    """`critic_nb` QNetworkVanilla critics (:343-361), their weights stacked:
    w<i> (C, in, out), b<i> (C, out), and LayerNorm ln_g<i>, ln_b<i> on
    every layer but the last."""

    def __init__(self, critic_nb: int, in_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (in_dim,) + Q_SIZES
        for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:])):
            bound = 1.0 / math.sqrt(n_in)
            w = torch.rand(critic_nb, n_in, n_out, generator=generator)
            setattr(self, f"w{i}", nn.Parameter(w * 2 * bound - bound))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(critic_nb, n_out)))
            if n_out > 1:
                setattr(self, f"ln_g{i}",
                        nn.Parameter(torch.ones(critic_nb, n_out)))
                setattr(self, f"ln_b{i}",
                        nn.Parameter(torch.zeros(critic_nb, n_out)))

    def forward(self, priv, actions, sel: Optional[torch.Tensor] = None):
        """(M, priv), (M, act) -> (C, M) Q-values; `sel` picks critics."""
        pick = (lambda p: p) if sel is None else (lambda p: p[sel])
        x = torch.cat([priv, actions], dim=-1)
        for i, n_out in enumerate(Q_SIZES):
            x = torch.matmul(x, pick(getattr(self, f"w{i}"))) \
                + pick(getattr(self, f"b{i}"))[:, None, :]
            if n_out > 1:
                x = F.layer_norm(x, (n_out,), eps=1e-5)
                x = F.elu(x * pick(getattr(self, f"ln_g{i}"))[:, None, :]
                          + pick(getattr(self, f"ln_b{i}"))[:, None, :])
        return x[..., 0]


# ----------------------------------------------------------------------
# sequence replay buffer (SeqReplayBuffer, DDPG_demos_generate.py:120-334)
# ----------------------------------------------------------------------
@dataclass
class SeqBuffer:
    obs: torch.Tensor            # (T, N, proprio) bf16
    priv: torch.Tensor           # (T, N, priv) bf16
    vobs: torch.Tensor           # (T, N, H, W) uint8
    actions: torch.Tensor        # (T, N, act)
    rewards: torch.Tensor        # (T, N)
    done_prob: torch.Tensor      # (T, N) CaT termination probabilities
    true_dones: torch.Tensor     # (T, N)
    hidden_in: torch.Tensor      # (T, N, rnn) bf16, actor hidden BEFORE the step
    pos: int = 0                 # write cursor
    filled: int = 0

    TENSORS = ("obs", "priv", "vobs", "actions", "rewards", "done_prob",
               "true_dones", "hidden_in")

    def nbytes(self) -> int:
        return sum(getattr(self, f).numel() * getattr(self, f).element_size()
                   for f in self.TENSORS)

    def to(self, device) -> "SeqBuffer":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in self.TENSORS})


def init_buffer(args: DDPGArgs, num_envs: int, priv_dim: int, act_dim: int,
                device="cpu") -> SeqBuffer:
    """obs, priv and hidden stored in bf16 (two resident buffers, the online
    ring and the expert demos), depth frames as uint8; `buffer_sample`
    casts back to f32."""
    T, N = args.buffer_steps, num_envs
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    h = torch.bfloat16
    return SeqBuffer(
        obs=z(T, N, args.proprio_dim, dtype=h), priv=z(T, N, priv_dim, dtype=h),
        vobs=z(T, N, args.vis_hw, args.vis_hw, dtype=torch.uint8),
        actions=z(T, N, act_dim), rewards=z(T, N), done_prob=z(T, N),
        true_dones=z(T, N), hidden_in=z(T, N, args.rnn_hidden, dtype=h))


def buffer_astype(buf: SeqBuffer) -> SeqBuffer:
    """A loaded demo buffer in the storage dtypes of `init_buffer` (older
    demo files hold f32 obs, priv and hidden)."""
    h = torch.bfloat16
    return dataclasses.replace(buf, obs=buf.obs.to(h), priv=buf.priv.to(h),
                               hidden_in=buf.hidden_in.to(h))


def buffer_add(buf: SeqBuffer, obs, priv, vobs_u8, actions, rewards,
               done_prob, true_dones, hidden_in) -> SeqBuffer:
    """Write one step at the cursor, in place; -> the buffer."""
    i = buf.pos
    for f, v in (("obs", obs), ("priv", priv), ("vobs", vobs_u8),
                 ("actions", actions), ("rewards", rewards),
                 ("done_prob", done_prob), ("true_dones", true_dones),
                 ("hidden_in", hidden_in)):
        dst = getattr(buf, f)
        dst[i] = v.to(dst.dtype)
    T = buf.obs.shape[0]
    buf.pos = (buf.pos + 1) % T
    buf.filled = min(buf.filled + 1, T)
    return buf


def buffer_sample(buf: SeqBuffer, draws: Draws, batch: int,
                  seq_len: int) -> Dict[str, torch.Tensor]:
    """`batch` (env, start) windows of `seq_len` steps (and the next step
    for the targets): dict of (B, L, ...) f32 tensors and the mask (B, L),
    0 after an in-window hard done. Offsets count from the OLDEST entry, so
    a window never crosses the ring's write seam once it has wrapped."""
    T, N = buf.rewards.shape[:2]
    max_start = max(buf.filled - seq_len - 1, 1)
    offsets = draws.randint(max_start, batch)
    oldest = buf.pos if buf.filled >= T else 0
    starts = (oldest + offsets) % T
    envs = draws.randint(N, batch)
    dev = buf.rewards.device
    t_idx = (starts[:, None] + torch.arange(seq_len, device=dev)) % T
    e_idx = envs[:, None]
    g = lambda a: a[t_idx, e_idx]
    g1 = lambda a: a[(t_idx + 1) % T, e_idx]
    dones = g(buf.true_dones)
    # valid until the first hard done inside the window (inclusive)
    prior_done = torch.cumsum(torch.cat(
        [torch.zeros_like(dones[:, :1]), dones[:, :-1]], 1), 1)
    f32 = lambda a: a.float()
    return {
        "obs": f32(g(buf.obs)), "priv": f32(g(buf.priv)),
        "vobs": g(buf.vobs).float() / 255.0,
        "actions": g(buf.actions), "rewards": g(buf.rewards),
        "done_prob": g(buf.done_prob), "true_dones": dones,
        "next_obs": f32(g1(buf.obs)), "next_priv": f32(g1(buf.priv)),
        "next_vobs": g1(buf.vobs).float() / 255.0,
        "hidden_in0": f32(buf.hidden_in[starts, envs]),
        "hidden_out0": f32(buf.hidden_in[(starts + 1) % T, envs]),
        "mask": (prior_done == 0).float(),
    }


def concat_batches(a: dict, b: dict) -> dict:
    """50/50 online/expert batch mixing (DDPG_demos_rnn_vision.py:543-560)."""
    return {k: torch.cat([a[k], b[k]], dim=0) for k in a}


def save_buffer(buf: SeqBuffer, path: str):
    """The port's demo file: the tensors (bf16 and uint8 kept) and the
    cursor, through `torch.save`."""
    torch.save({"seq_buffer": {f: getattr(buf, f).cpu()
                               for f in SeqBuffer.TENSORS},
                "pos": buf.pos, "filled": buf.filled}, path)


def load_buffer(path: str, device="cpu") -> SeqBuffer:
    """A demo file of `save_buffer`, or the JAX package's `rb_demos.pkl`
    (read without JAX: `learn.jax_checkpoint.load_seq_buffer`), on
    `device` in the storage dtypes."""
    from . import jax_checkpoint
    if jax_checkpoint.is_jax_checkpoint(path):
        buf = jax_checkpoint.load_seq_buffer(path)
    else:
        blob = torch.load(path, map_location="cpu", weights_only=True)
        buf = SeqBuffer(**blob["seq_buffer"], pos=int(blob["pos"]),
                        filled=int(blob["filled"]))
    return buffer_astype(buf).to(device)


# ----------------------------------------------------------------------
# the learner: networks, optimizers and the four updates
# ----------------------------------------------------------------------
class DDPGLearner:
    """The JAX `DDPGTrainState`: vision net, actor, the critics and their
    targets, the actor optimizer (actor and vision together) and the critic
    optimizer, each clip_by_global_norm(0.5) + Adam, the draws and the
    actor-update count."""

    def __init__(self, priv_dim: int, act_dim: int,
                 args: DDPGArgs = DDPGArgs(), seed: int = 0, device="cpu"):
        self.args = args
        dev = self.device = torch.device(device)
        init_gen = torch.Generator()
        init_gen.manual_seed(int(seed))
        self.student = Student(act_dim, args, init_gen).to(dev)
        self.vision, self.actor = self.student.vision, self.student.actor
        self.qs = QEnsemble(args.critic_nb, priv_dim + act_dim,
                            init_gen).to(dev)
        self.q_targets = copy.deepcopy(self.qs).requires_grad_(False)
        self.actor_params = list(self.student.parameters())
        self.reset_actor_opt()
        self.q_opt = torch.optim.Adam(self.qs.parameters(), lr=args.critic_lr)
        self.draws = Draws(dev, seed + 1)
        self.step = 0
        self.last_losses: Dict[str, torch.Tensor] = {}

    def reset_actor_opt(self):
        self.actor_opt = torch.optim.Adam(self.actor_params,
                                          lr=self.args.actor_lr)

    def state(self) -> dict:
        return {"student": self.student.state_dict(),
                "qs": self.qs.state_dict(),
                "q_targets": self.q_targets.state_dict(),
                "actor_opt": self.actor_opt.state_dict(),
                "q_opt": self.q_opt.state_dict(), "step": self.step,
                "gen_state": self.draws.gen.get_state()}

    def load_state(self, blob: dict):
        self.student.load_state_dict(blob["student"])
        self.qs.load_state_dict(blob["qs"])
        self.q_targets.load_state_dict(blob["q_targets"])
        self.actor_opt.load_state_dict(blob["actor_opt"])
        self.q_opt.load_state_dict(blob["q_opt"])
        self.step = int(blob["step"])
        self.draws.gen.set_state(blob["gen_state"])

    def run_actor_seq(self, obs_seq, vobs_seq, h0):
        """The actor over a (B, L, ...) window from hidden h0; the vision
        latent is refreshed every `vision_update_interval` steps (:494-497),
        so only those frames go through the CNN. -> (B, L, act)."""
        B, L = obs_seq.shape[:2]
        k = self.args.vision_update_interval
        frames = list(range(0, L, k))
        vlat = self.vision(vobs_seq[:, frames].reshape(
            B * len(frames), *vobs_seq.shape[2:])).reshape(B, len(frames), -1)
        h, acts = h0, []
        for t in range(L):
            a, h = self.actor(obs_seq[:, t], vlat[:, t // k], h)
            acts.append(a)
        return torch.stack(acts, dim=1)

    def _step(self, opt, params, loss):
        opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        clip_by_global_norm_(params, 0.5)
        opt.step()

    def q_update(self, batch, noise=None, sel=None) -> torch.Tensor:
        """One critic step (:312-348). `noise`: standard normal draws of the
        actions' shape; `sel`: the two target critics."""
        a = self.args
        B, L = batch["rewards"].shape
        fl = lambda x: x.reshape((B * L,) + x.shape[2:])
        if noise is None:
            noise = self.draws.normal(batch["actions"].shape)
        noise = torch.clamp(a.policy_noise * noise, -a.noise_clip,
                            a.noise_clip)
        with torch.no_grad():
            next_actions = self.run_actor_seq(
                batch["next_obs"], batch["next_vobs"], batch["hidden_out0"])
            next_actions = torch.clamp(next_actions + noise, a.action_low,
                                       a.action_high)
            if sel is None:
                sel = self.draws.permutation(a.critic_nb)[:2]
            min_q_next = self.q_targets(fl(batch["next_priv"]),
                                        fl(next_actions), sel).amin(0)
            p, td = fl(batch["done_prob"]), fl(batch["true_dones"])
            target = ((1 - p) * fl(batch["rewards"])
                      + (1 - p) * (1 - td) * a.gamma * min_q_next)   # :585
        mask = fl(batch["mask"])
        n_valid = torch.clamp_min(mask.sum(), 1.0)
        qv = self.qs(fl(batch["priv"]), fl(batch["actions"]))
        loss = (torch.square(qv - target[None, :]) * mask[None, :]).sum() \
            / (n_valid * a.critic_nb)
        self._step(self.q_opt, list(self.qs.parameters()), loss)
        return loss.detach()

    @torch.no_grad()
    def target_update(self):
        tau = self.args.tau
        for p, t in zip(self.qs.parameters(), self.q_targets.parameters()):
            t.copy_(tau * p + (1 - tau) * t)

    def actor_update(self, batch) -> torch.Tensor:
        """One deterministic-policy-gradient step through all critics
        (:355-374); only the actor and the vision net step."""
        B, L = batch["rewards"].shape
        mask = batch["mask"].reshape(B * L)
        n_valid = torch.clamp_min(mask.sum(), 1.0)
        acts = self.run_actor_seq(batch["obs"], batch["vobs"],
                                  batch["hidden_in0"])
        qv = self.qs(batch["priv"].reshape(B * L, -1), acts.reshape(B * L, -1))
        loss = -(qv * mask[None, :]).sum() / (n_valid * self.args.critic_nb)
        self._step(self.actor_opt, self.actor_params, loss)
        self.step += 1
        return loss.detach()

    def bc_update(self, batch) -> torch.Tensor:
        """Behavior cloning on expert windows (:376-403): masked MSE of the
        student's actions against the expert's, clipped to the tanh range.
        Not in the reference: a warm start before the DDPG phase (a
        documented deviation of the JAX package, BASELINE.md)."""
        a = self.args
        mask = batch["mask"][..., None]
        target = torch.clamp(batch["actions"], a.action_low, a.action_high)
        n_valid = torch.clamp_min(mask.sum() * target.shape[-1], 1.0)
        acts = self.run_actor_seq(batch["obs"], batch["vobs"],
                                  batch["hidden_in0"])
        loss = (torch.square(acts - target) * mask).sum() / n_valid
        self._step(self.actor_opt, self.actor_params, loss)
        return loss.detach()

    def update_round(self, rb: SeqBuffer, expert: SeqBuffer, actor_on: bool):
        """`updates_per_step` substeps (:533-553), each on a half online,
        half expert batch: the critic step, the target update on every
        `policy_frequency`-th substep, and on the last one the actor step
        (when `actor_on`) against the updated critics. -> (mean critic
        loss, actor loss or 0)."""
        a = self.args
        half = a.batch_size // 2
        q_losses, a_loss = [], torch.zeros((), device=self.device)
        for i in range(a.updates_per_step):
            batch = concat_batches(
                buffer_sample(rb, self.draws, half, a.seq_len),
                buffer_sample(expert, self.draws, a.batch_size - half,
                              a.seq_len))
            q_losses.append(self.q_update(batch))
            if i % a.policy_frequency == 0:
                self.target_update()
            if i == a.updates_per_step - 1 and actor_on:
                a_loss = self.actor_update(batch)
        return torch.stack(q_losses).mean(), a_loss


# ----------------------------------------------------------------------
# the two stages
# ----------------------------------------------------------------------
def _renderer(env, args: DDPGArgs):
    from ..envs.depth import DepthCameraCfg, make_depth_fn
    return make_depth_fn(env.hf, DepthCameraCfg(height=args.vis_hw,
                                                 width=args.vis_hw),
                         model=env.model)


def _frame(render, world):
    p = world.env.phys
    return render(p.base_pos, p.base_quat, p.joint_q)


@torch.no_grad()
def generate_demos(expert_policy_fn, env, steps: int, seed: int,
                   args: DDPGArgs, buffer: Optional[SeqBuffer] = None):
    """Fill a demo buffer with an expert policy (DDPG_demos_generate
    :339-431). expert_policy_fn(full obs (N, obs)) -> actions; proprio is
    obs[:, :45], depth the camera's frame of the pre-step state."""
    N, dev = env.num_envs, env.device
    if buffer is None:
        buffer = init_buffer(args, N, env.num_obs, env.num_actions, dev)
    render = _renderer(env, args)
    world = env.init_state(seed)
    obs = env.get_observations(world)
    zero_h = torch.zeros(N, args.rnn_hidden, device=dev)
    for _ in range(steps):
        actions = expert_policy_fn(obs)
        vobs_u8 = (_frame(render, world) * 255).to(torch.uint8)
        world, next_obs, rew, done_prob, info = env.step(world, actions)
        buffer_add(buffer, obs[:, :args.proprio_dim], obs, vobs_u8, actions,
                   rew, done_prob, info["true_dones"].float(), zero_h)
        obs = next_obs
    return buffer


class Collector:
    """The student's online collection (:509-530): the depth frame of the
    pre-step state, the latent refreshed every `vision_update_interval`
    steps, the GRU actor (uniform random actions during the warm-up, the
    hidden then held), the env step, the hidden zeroed on hard dones, and
    the step written into the online ring `rb`."""

    def __init__(self, env, learner: DDPGLearner, args: DDPGArgs,
                 seed: int = 0):
        N, dev = env.num_envs, env.device
        self.env, self.learner, self.args = env, learner, args
        self.rb = init_buffer(args, N, env.num_obs, env.num_actions, dev)
        self.render = _renderer(env, args)
        self.world = env.init_state(seed)
        self.obs = env.get_observations(self.world)
        self.hidden = torch.zeros(N, args.rnn_hidden, device=dev)
        self.vlat = torch.zeros(N, args.vision_latent, device=dev)
        self.step = 0

    @torch.no_grad()
    def collect(self) -> torch.Tensor:
        """One env step; -> its rewards."""
        args, ln, N = self.args, self.learner, self.env.num_envs
        vobs = _frame(self.render, self.world)
        if self.step % args.vision_update_interval == 0:
            self.vlat = ln.vision(vobs)
        proprio = self.obs[:, :args.proprio_dim]
        actions, hidden_out = ln.actor(proprio, self.vlat, self.hidden)
        if self.step * N < args.learning_starts:             # warm-up
            actions = ln.draws.uniform(actions.shape, args.action_low,
                                       args.action_high)
            hidden_out = self.hidden
        self.world, next_obs, rew, done_prob, info = self.env.step(
            self.world, actions)
        td = info["true_dones"].float()
        buffer_add(self.rb, proprio, self.obs, (vobs * 255).to(torch.uint8),
                   actions, rew, done_prob, td, self.hidden)
        self.hidden = hidden_out * (1.0 - td)[:, None]       # :519-521
        self.obs = next_obs
        self.step += 1
        return rew


def train_vision_student(env, expert_buffer: SeqBuffer, total_env_steps: int,
                         seed: int = 0, args: DDPGArgs = DDPGArgs(),
                         log_fn=print, log_freq: int = 24, bc_batches: int = 0,
                         learner: Optional[DDPGLearner] = None):
    """The DDPG_demos_rnn_vision main loop (:393-630): online collection
    with the recurrent vision actor, then `updates_per_step` update
    substeps per env step once `learning_starts` env steps are in.
    `bc_batches` > 0 runs a behavior-cloning warm start on the demos first
    (one batch an update), then gives the actor a fresh optimizer and holds
    its updates for `actor_delay_env_steps`. `learner`: start from this
    learner (default: a new one from `seed`). -> (learner, online ring);
    the last losses are in `learner.last_losses`."""
    N = env.num_envs
    if learner is None:
        learner = DDPGLearner(env.num_obs, env.num_actions, args, seed,
                              env.device)
    if bc_batches:
        for done_b in range(1, bc_batches + 1):
            bc_loss = learner.bc_update(buffer_sample(
                expert_buffer, learner.draws, args.batch_size, args.seq_len))
            if done_b % 500 == 0 or done_b == bc_batches:
                log_fn(f"bc {done_b:5d}/{bc_batches} | "
                       f"bc_loss {float(bc_loss):.4f}")
        # fresh actor optimizer for the DDPG phase: Adam moments fitted to
        # the BC loss would otherwise seed the first policy-gradient steps
        learner.reset_actor_opt()
    col = Collector(env, learner, args, seed)
    # after a BC warm start the actor is already competent while the Q
    # ensemble is random: hold actor updates (Q/targets keep training)
    actor_hold = args.actor_delay_env_steps // N if bc_batches else 0
    for step in range(total_env_steps // N):
        rew = col.collect()
        if (step + 1) * N > args.learning_starts:
            q_loss, a_loss = learner.update_round(col.rb, expert_buffer,
                                                  step >= actor_hold)
            learner.last_losses = {"q_loss": q_loss, "actor_loss": a_loss}
            if step % log_freq == 0:
                log_fn(f"step {step:5d} | rew {float(rew.mean()):.3f} | "
                       f"q_loss {float(q_loss):.4f} | "
                       f"actor_loss {float(a_loss):.4f}")
    return learner, col.rb
