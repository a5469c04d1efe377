"""The yardstick's counts against hand counts: the learners' network
FLOPs at the cells' shapes, and the physics kernels' bytes from their row
widths."""
from __future__ import annotations

import pytest

from port_bench import cells
from port_bench.counts import kernels as K


def test_ppo_cse_flops_go1_mob():
    # towers: adaptation 2100-256-128-2, actor and critic 2102-512-256-128
    ad = 2100 * 256 + 256 * 128 + 128 * 2
    act = 2102 * 512 + 512 * 256 + 256 * 128 + 128 * 12
    cri = 2102 * 512 + 512 * 256 + 256 * 128 + 128 * 1
    fwd = ad + act + cri
    rollout = 24 * 4000 * fwd + 4000 * cri
    d_x = (256 * 128 + 128 * 2) + (512 * 256 + 256 * 128 + 128 * 12) \
        + 2 * 512 + (512 * 256 + 256 * 128 + 128)
    substep = 2 * ad + (256 * 128 + 128 * 2)
    update = 5 * 24 * 4000 * (2 * fwd + d_x + substep)
    got = cells.flops("ppo_cse").flops_per_iteration(
        cells.load_cell("go1_mob.fp32"))
    assert got == 2.0 * (rollout + update)
    assert 7.5e12 < got < 8.5e12


def test_cat_ppo_flops_parkour():
    act = 189 * 512 + 512 * 256 + 256 * 128 + 128 * 12
    cri = 189 * 512 + 512 * 256 + 256 * 128 + 128
    fwd = act + cri
    n = 24 * 4096
    d_x = (act - 189 * 512) + (cri - 189 * 512)
    want = 2.0 * (n * fwd + 4096 * cri + 5 * n * (2 * fwd + d_x))
    got = cells.flops("ppo").flops_per_iteration(
        cells.load_cell("parkour.cat_ppo"))
    assert got == want
    assert 1.4e12 < got < 1.5e12


def test_ppornn_flops_parkour():
    gru = 3 * 256 * (189 + 256)
    act = 445 * 512 + 512 * 256 + 256 * 128 + 128 * 12
    cri = 445 * 512 + 512 * 256 + 256 * 128 + 128
    fwd = 2 * gru + act + cri
    d_x = (act - 445 * 512 + 256 * 512) + (cri - 445 * 512 + 256 * 512) \
        + 6 * 256 * 256
    samples = 5 * (4096 // 6) * 6 * 24
    want = 2.0 * (25 * 4096 * fwd + samples * (2 * fwd + d_x))
    got = cells.flops("ppornn").flops_per_iteration(
        cells.load_cell("parkour.cat_ppornn"))
    assert got == want
    assert 4.0e12 < got < 4.3e12


@pytest.mark.parametrize("robot,P", [("go1", 39), ("go2", 51)])
def test_kernel_bytes_from_row_widths(robot, P):
    nb, nj, nv, p, anc = K.robot_dims(robot)
    assert (nb, nj, nv, p) == (13, 12, 18, P)
    # kernel A: in base pos 3, quat 4, joints 12; out body pos/quat 13 x 7,
    # joint anchors and axes 12 x 6; sphere positions 3 P
    assert K.fk_bytes(nb, nj, p) == 4 * (19 + 91 + 72 + 3 * P)
    # kernel B: in state 3+4+12, velocities 18, torques 12; FK rows 163;
    # spheres 3 P, corners 4 P, offsets 2 P; 9 env rows; ceiling P; out
    # 3+4+3+3+12+12+12+12+12+4+4+1+1
    out = 3 + 4 + 3 + 3 + 12 + 12 + 12 + 12 + 12 + 4 + 4 + 1 + 1
    for ceil in (False, True):
        want = 4 * (49 + 163 + 9 * P + 9 + (P if ceil else 0) + out)
        assert K.dynamics_bytes(nb, nj, nv, p, ceil) == want


def test_least_time_takes_the_larger_bound():
    assert K.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert K.least_seconds(0, 67e12) == pytest.approx(1.0)
    nb, nj, nv, P, anc = K.robot_dims("go1")
    # both kernels are bound by bytes at these counts
    assert K.fk_bytes(nb, nj, P) / 3.35e12 > K.fk_flops(nb, nj, P) / 67e12
    assert (K.dynamics_bytes(nb, nj, nv, P, False) / 3.35e12
            > K.dynamics_flops(nb, nj, nv, P, anc, False) / 67e12)
