"""Reward-threshold command curriculum, batched (port of
`wtw_tpu/envs/curriculum.py`; reference go1_gym/envs/base/curriculum.py
and legged_robot.py:710-824).

The command grid is flattened to `n_bins` cells; each gait category has a
weight vector over cells. Sampling is inverse-CDF over the weights plus
uniform jitter within the cell; the update bumps each successful cell and
its box neighbourhood by 0.2, clipped to [0, 1].

The samplers take their uniform draws as arguments: the env draws them
from its `torch.Generator`, and the tests feed both implementations the
same numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import CommandsCfg
from ..parallel.mesh import all_sum

DIM_NAMES = ("vel_x", "vel_y", "vel_yaw", "body_height", "gait_frequency",
             "gait_phase", "gait_offset", "gait_bound", "gait_duration",
             "footswing_height", "body_pitch", "body_roll", "stance_width",
             "stance_length", "aux_reward_coef")

# neighbour dilation ranges per dim (legged_robot.py:737-739)
LOCAL_RANGE = np.array([0.55, 0.55, 0.55, 0.55, 0.35, 0.25, 0.25, 0.25, 0.25,
                        1.0, 1.0, 1.0, 1.0, 1.0, 1.0])

CATEGORIES = ("pronk", "trot", "pace", "bound")


@dataclasses.dataclass(frozen=True)
class CurriculumGrid:
    centers: torch.Tensor     # (n_dims, n_bins) cell centers
    bin_sizes: torch.Tensor   # (n_dims,)
    adjacency: torch.Tensor   # (n_bins, n_bins) float {0, 1}
    lows: torch.Tensor        # (n_dims,)
    highs: torch.Tensor       # (n_dims,)


def _limits_and_bins(cmd: CommandsCfg) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lims = np.array([
        cmd.limit_vel_x, cmd.limit_vel_y, cmd.limit_vel_yaw,
        cmd.limit_body_height, cmd.limit_gait_frequency, cmd.limit_gait_phase,
        cmd.limit_gait_offset, cmd.limit_gait_bound, cmd.limit_gait_duration,
        cmd.limit_footswing_height, cmd.limit_body_pitch, cmd.limit_body_roll,
        cmd.limit_stance_width, cmd.limit_stance_length,
        cmd.limit_aux_reward_coef])
    nbins = np.array([
        cmd.num_bins_vel_x, cmd.num_bins_vel_y, cmd.num_bins_vel_yaw,
        cmd.num_bins_body_height, cmd.num_bins_gait_frequency,
        cmd.num_bins_gait_phase, cmd.num_bins_gait_offset,
        cmd.num_bins_gait_bound, cmd.num_bins_gait_duration,
        cmd.num_bins_footswing_height, cmd.num_bins_body_pitch,
        cmd.num_bins_body_roll, cmd.num_bins_stance_width,
        cmd.num_bins_stance_length, cmd.num_bins_aux_reward_coef])
    return lims[:, 0], lims[:, 1], nbins


def initial_ranges(cmd: CommandsCfg) -> np.ndarray:
    """Initial command support (legged_robot.py:1364-1381)."""
    return np.array([
        cmd.lin_vel_x, cmd.lin_vel_y, cmd.ang_vel_yaw, cmd.body_height_cmd,
        cmd.gait_frequency_cmd_range, cmd.gait_phase_cmd_range,
        cmd.gait_offset_cmd_range, cmd.gait_bound_cmd_range,
        cmd.gait_duration_cmd_range, cmd.footswing_height_range,
        cmd.body_pitch_range, cmd.body_roll_range, cmd.stance_width_range,
        cmd.stance_length_range, cmd.aux_reward_coef_range])


def build_grid(cmd: CommandsCfg, device="cpu") -> CurriculumGrid:
    low, high, nbins = _limits_and_bins(cmd)
    bin_sizes = (high - low) / nbins
    axes = [np.linspace(low[d] + bin_sizes[d] / 2, high[d] - bin_sizes[d] / 2,
                        nbins[d]) for d in range(len(nbins))]
    mesh = np.meshgrid(*axes, indexing="ij")
    centers = np.stack([m.reshape(-1) for m in mesh])
    diff = np.abs(centers[:, :, None] - centers[:, None, :])
    adjacency = np.all(diff <= LOCAL_RANGE[:, None, None], axis=0)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return CurriculumGrid(centers=f32(centers), bin_sizes=f32(bin_sizes),
                          adjacency=f32(adjacency), lows=f32(low),
                          highs=f32(high))


def init_weights(cmd: CommandsCfg, grid: CurriculumGrid) -> torch.Tensor:
    """(n_categories, n_bins): 1.0 for cells whose center lies inside the
    initial command ranges (Curriculum.set_to, curriculum.py:18-26)."""
    rng = torch.as_tensor(np.asarray(initial_ranges(cmd), np.float32),
                          device=grid.centers.device)
    inside = torch.all((grid.centers >= rng[:, 0:1])
                       & (grid.centers <= rng[:, 1:2]), dim=0)
    n_cat = len(CATEGORIES) if cmd.gaitwise_curricula else 1
    return inside.float()[None].repeat(n_cat, 1)


def sample_commands_batched(grid: CurriculumGrid, weights: torch.Tensor,
                            categories: torch.Tensor, u_bin: torch.Tensor,
                            u_jitter: torch.Tensor):
    """(N,) categories + uniforms u_bin (N,) in [0, 1) and u_jitter
    (N, n_dims) in [0, 1) -> ((N, n_dims) commands, (N,) bins).
    Inverse-CDF over the category's weights (curriculum.py:76-78) and
    jitter within the cell (:82-85)."""
    cdf = torch.cumsum(weights, dim=1)[categories]           # (N, n_bins)
    r = u_bin * cdf[:, -1]
    bin_idx = torch.sum(cdf <= r[:, None], dim=1).clamp(0, weights.shape[1] - 1)
    center = grid.centers.T[bin_idx]                          # (N, n_dims)
    cmd = center + (u_jitter - 0.5) * grid.bin_sizes
    return cmd, bin_idx


def apply_gait_category_batched(commands: torch.Tensor, category: torch.Tensor,
                                binary_phases: bool) -> torch.Tensor:
    """Per-category phase/offset/bound shaping (legged_robot.py:763-817)."""
    phase, offset, bound = commands[:, 5], commands[:, 6], commands[:, 7]
    z = torch.zeros_like(phase)
    p_sel = torch.stack([(phase / 2 - 0.25) % 1.0, phase / 2 + 0.25, z, z], -1)
    o_sel = torch.stack([(offset / 2 - 0.25) % 1.0, z, offset / 2 + 0.25, z], -1)
    b_sel = torch.stack([(bound / 2 - 0.25) % 1.0, z, z, bound / 2 + 0.25], -1)
    pick = lambda sel: sel.gather(1, category[:, None].long())[:, 0]
    new = [pick(p_sel), pick(o_sel), pick(b_sel)]
    if binary_phases:
        new = [(torch.round(2 * x) / 2.0) % 1.0 for x in new]
    out = commands.clone()
    out[:, 5], out[:, 6], out[:, 7] = new
    return out


def update_weights(grid: CurriculumGrid, weights: torch.Tensor,
                   env_category: torch.Tensor, env_bin: torch.Tensor,
                   success: torch.Tensor, mask: torch.Tensor,
                   group=None) -> torch.Tensor:
    """RewardThresholdCurriculum.update (curriculum.py:135-154): each success
    bumps its own bin and every adjacent bin by 0.2 (the own bin, inside its
    own neighbourhood, gets 0.4), clipped to [0, 1]. Under env sharding the
    success counts are summed over the `group`, so every rank applies the
    same update to the one curriculum."""
    n_cat, n_bins = weights.shape
    contrib = (success & mask).float()
    succ = torch.zeros(n_cat, n_bins, device=weights.device)
    succ.index_put_((env_category.long(), env_bin.long()), contrib,
                    accumulate=True)
    succ = all_sum(succ, group)
    bumps = succ + succ @ grid.adjacency
    return torch.clamp(weights + 0.2 * bumps, 0.0, 1.0)
