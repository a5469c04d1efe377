"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: each test decides inside itself whether a CUDA device is
present and skips otherwise (CPU runs hold the same arithmetic through
tests/test_torch_physics.py's host build of the sources). Run on a GPU
machine with

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Bars: kernel A at 1e-5 (tests/test_physics_batched.py:162-188); kernel B at
tests/test_physics_batched.py:157-159 (lin vel 1e-4, joint qd 1e-3, foot
forces 1e-1), positions and orientations at 1e-5.
"""
import numpy as np
import pytest
import torch

from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                   flat_heightfield, make_heightfield,
                                   physics_step_batched)
from wtw_tpu_torch.physics import kernels as K
from wtw_tpu_torch.physics.batched import (_hf_height, _hf_rows,
                                           pack_state_rows)

pytestmark = pytest.mark.gpu

B = 4096


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _states(dev, seed=0, n=B):
    rng = np.random.RandomState(seed)
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    q = rng.randn(n, 4) * 0.1 + np.array([0.0, 0.0, 0.0, 1.0])
    st = PhysicsState(
        base_pos=t(np.concatenate([rng.uniform(-1, 1, (n, 2)),
                                   0.30 + rng.uniform(-0.05, 0.1, (n, 1))], 1)),
        base_quat=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
        base_lin_vel=t(0.5 * rng.randn(n, 3)),
        base_ang_vel=t(0.5 * rng.randn(n, 3)),
        joint_q=t(np.tile([0.0, 0.8, -1.6] * 4, (n, 1))
                  + 0.1 * rng.randn(n, 12)),
        joint_qd=t(0.5 * rng.randn(n, 12)))
    return st, t(3.0 * rng.randn(n, 12))


def test_kernel_a_matches_plain():
    dev = _device()
    model = load_robot("go1", device=dev)
    st, _ = _states(dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    n0 = K.FK.launches
    got_b, got_p = K.fk(model, fk_in)
    assert K.FK.launches == n0 + 1
    ref_b, ref_p = K.fk_plain(model, fk_in)
    torch.testing.assert_close(got_b, ref_b, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_p, ref_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize("terrain", ["flat", "rough"])
def test_kernel_b_matches_plain(terrain):
    dev = _device()
    model = load_robot("go1", device=dev)
    st, tau = _states(dev, 1)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    if terrain == "flat":
        hf = flat_heightfield(20.0, 0.5, device=dev)
    else:
        hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
        hf = make_heightfield(hts, 0.25, [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    env = torch.cat([torch.linspace(0.3, 2.0, B, device=dev)[None],
                     torch.linspace(0.0, 0.4, B, device=dev)[None],
                     torch.linspace(-0.5, 2.0, B, device=dev)[None],
                     torch.zeros(6, B, device=dev)], 0).contiguous()
    args = (model, EngineParams(), pack_state_rows(st, tau), fk_b, fk_p,
            hc.contiguous(), duv.contiguous(), env, 1.0 / hf.horizontal_scale)
    n0 = K.DYNAMICS.launches
    got = K.dynamics(*args)
    assert K.DYNAMICS.launches == n0 + 1
    ref = K.dynamics_plain(*args)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        torch.testing.assert_close(g[k], r[k], rtol=0, atol=tol.get(k, 1e-5),
                                   msg=k)


def test_kernel_b_with_ceiling_matches_plain():
    """Go2 (51 spheres) over rough ground under a rough ceiling at
    0.36 +- 0.02 m that some spheres touch (asserted), at the bars above."""
    dev = _device()
    model = load_robot("go2", device=dev)
    st, tau = _states(dev, 2)
    st.joint_q += torch.tensor([0.1, 0.0, 0.1, -0.1, 0.0, 0.1,
                                0.1, 0.2, 0.1, -0.1, 0.2, 0.1], device=dev)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    rs = lambda seed: np.random.RandomState(seed).randn(80, 80)
    hf = make_heightfield((0.03 * rs(3)).astype(np.float32), 0.25,
                          [-10.0, -10.0], device=dev)
    ceil = make_heightfield((0.36 + 0.02 * rs(5)).astype(np.float32), 0.25,
                            [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    ceil_h = _hf_height(ceil, fk_p[0], fk_p[1]).contiguous()
    assert int((fk_p[2] + model.sph_radius[:, None] > ceil_h).sum()) > 0
    env = torch.cat([torch.linspace(0.3, 2.0, B, device=dev)[None],
                     torch.zeros(8, B, device=dev)], 0).contiguous()
    args = (model, EngineParams(), pack_state_rows(st, tau), fk_b, fk_p,
            hc.contiguous(), duv.contiguous(), env, 4.0)
    n0 = K.DYNAMICS.launches
    got = K.dynamics(*args, ceil_h=ceil_h)
    assert K.DYNAMICS.launches == n0 + 1
    ref = K.dynamics_plain(*args, ceil_h=ceil_h)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        torch.testing.assert_close(g[k], r[k], rtol=0, atol=tol.get(k, 1e-5),
                                   msg=k)


@pytest.mark.parametrize("robot,z", [("b1", 0.49), ("mini_cheetah", 0.45)])
def test_kernels_match_plain_on_b1_and_mini_cheetah(robot, z):
    """B1 (31 spheres, 55.7 kg) and the mini-cheetah (52 spheres) over rough
    ground, bases a little below the standing height of each robot's
    default pose (0.52 m and 0.47 m), so most envs touch: kernel A at 1e-5
    and kernel B at the bars above, each launch counted."""
    dev = _device()
    model = load_robot(robot, device=dev)
    st, tau = _states(dev, 4)
    st.base_pos[:, 2] += z - 0.30
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    n0 = (K.FK.launches, K.DYNAMICS.launches)
    got_b, got_p = K.fk(model, fk_in)
    ref_b, fk_p = K.fk_plain(model, fk_in)
    torch.testing.assert_close(got_b, ref_b, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_p, fk_p, rtol=0, atol=1e-5)
    hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    hf = make_heightfield(hts, 0.25, [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    env = torch.cat([torch.linspace(0.3, 2.0, B, device=dev)[None],
                     torch.zeros(8, B, device=dev)], 0).contiguous()
    args = (model, EngineParams(), pack_state_rows(st, tau), ref_b, fk_p,
            hc.contiguous(), duv.contiguous(), env, 4.0)
    got, ref = K.dynamics(*args), K.dynamics_plain(*args)
    assert (K.FK.launches - n0[0], K.DYNAMICS.launches - n0[1]) == (1, 1)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    assert float(r["total_normal_force"].max()) > 10.0
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        torch.testing.assert_close(g[k], r[k], rtol=0, atol=tol.get(k, 1e-5),
                                   msg=k)


def _rough_case(dev, n, seed=1):
    """go1 over rough ground at n envs: kernel B's inputs."""
    model = load_robot("go1", device=dev)
    st, tau = _states(dev, seed, n)
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    hf = make_heightfield(hts, 0.25, [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    env = torch.cat([torch.linspace(0.3, 2.0, n, device=dev)[None],
                     torch.linspace(0.0, 0.4, n, device=dev)[None],
                     torch.linspace(-0.5, 2.0, n, device=dev)[None],
                     torch.zeros(6, n, device=dev)], 0).contiguous()
    args = (model, EngineParams(), pack_state_rows(st, tau), fk_b, fk_p,
            hc.contiguous(), duv.contiguous(), env, 4.0)
    return model, fk_in, args


def test_ragged_batch_matches_plain():
    """4000 envs (go1_mob's default), not a multiple of a block's 8 envs:
    the last block's teams past B run every phase with their loads and
    stores masked; both kernels at the bars above."""
    dev = _device()
    model, fk_in, args = _rough_case(dev, 4000)
    got_b, got_p = K.fk(model, fk_in)
    ref_b, ref_p = K.fk_plain(model, fk_in)
    torch.testing.assert_close(got_b, ref_b, rtol=0, atol=1e-5)
    torch.testing.assert_close(got_p, ref_p, rtol=0, atol=1e-5)
    got, ref = K.dynamics(*args), K.dynamics_plain(*args)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        torch.testing.assert_close(g[k], r[k], rtol=0, atol=tol.get(k, 1e-5),
                                   msg=k)


def test_kernels_are_deterministic():
    """No floating-point atomics: two launches on the same inputs give the
    same bits, for both kernels."""
    dev = _device()
    model, fk_in, args = _rough_case(dev, B)
    a, b = K.fk(model, fk_in), K.fk(model, fk_in)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(K.dynamics(*args), K.dynamics(*args))


def test_launch_shape_fits_the_card():
    """Each kernel's block fits the SM's shared memory and at least one
    block is resident per SM."""
    _device()
    for name, sh in K.launch_shape().items():
        assert sh["shared_bytes_per_block"] <= 227 * 1024, name
        assert sh["blocks_per_sm"] >= 1, name


def test_physics_step_runs_the_kernels_and_stays_standing():
    dev = _device()
    model = load_robot("go1", device=dev)
    hf = flat_heightfield(20.0, 0.5, device=dev)
    q0 = torch.tensor([0.0, 0.8, -1.6] * 4, device=dev).expand(B, 12)
    s = PhysicsState(
        base_pos=torch.tensor([0.0, 0.0, 0.32], device=dev).expand(B, 3),
        base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(B, 4),
        base_lin_vel=torch.zeros(B, 3, device=dev),
        base_ang_vel=torch.zeros(B, 3, device=dev), joint_q=q0.clone(),
        joint_qd=torch.zeros(B, 12, device=dev))
    n0 = (K.FK.launches, K.DYNAMICS.launches)
    for _ in range(100):
        tau = 20.0 * (q0 - s.joint_q) - 0.5 * s.joint_qd
        s, _ = physics_step_batched(model, hf, EngineParams(), s, tau,
                                    torch.ones(B, device=dev),
                                    torch.zeros(B, device=dev))
    torch.cuda.synchronize()
    assert (K.FK.launches - n0[0], K.DYNAMICS.launches - n0[1]) == (100, 100)
    z = s.base_pos[:, 2]
    assert bool(torch.isfinite(s.base_pos).all())
    assert bool((z > 0.15).all()) and bool((z < 0.45).all())


def test_wrapper_refuses_bad_inputs():
    dev = _device()
    model = load_robot("go1", device=dev)
    with pytest.raises(ValueError):
        K.fk(model, torch.zeros(19, 8, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError):
        K.fk(model, torch.zeros(8, 19, device=dev).T)


MIX = ("go1", "go2", "b1", "mini_cheetah")
# train_multi's default mix as chip_smoke.py trains it: 51 spheres, runs of
# 1366/1365/1365 envs padded to 1376 slots, so blocks hold empty slots
TRAIN_MIX = ("go1", "go2", "b1")
MIX_Z = {"go1": 0.30, "go2": 0.30, "b1": 0.49, "mini_cheetah": 0.45}


def _mixed_case(dev, robots=MIX, n=B, assignment=None, seed=2):
    """The per-env model of a stack of `robots`, env i robot
    `assignment[i]` (arange % R by default), random states near each env's
    robot's height."""
    from wtw_tpu_torch.models.multi import stack_models
    stack = stack_models([load_robot(r, device=dev) for r in robots])
    a = np.arange(n) % len(robots) if assignment is None else assignment
    per_env = stack.take(a)
    st, tau = _states(dev, seed, n)
    z = torch.tensor([MIX_Z[robots[r]] - 0.30 for r in a], device=dev)
    st.base_pos[:, 2] += z
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    return per_env, st, tau, fk_in


def _rows_b(dev, fk_p, terrain, n=B):
    if terrain == "flat":
        hf = flat_heightfield(20.0, 0.5, device=dev)
    else:
        hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
        hf = make_heightfield(hts, 0.25, [-10.0, -10.0], device=dev)
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    env = torch.cat([torch.linspace(0.3, 2.0, n, device=dev)[None],
                     torch.linspace(0.0, 0.4, n, device=dev)[None],
                     torch.zeros(7, n, device=dev)], 0).contiguous()
    return hc.contiguous(), duv.contiguous(), env, 1.0 / hf.horizontal_scale


@pytest.mark.parametrize("terrain,robots", [
    ("flat", MIX), ("rough", MIX), ("train-flat", TRAIN_MIX),
    ("train-rough", TRAIN_MIX)],
    ids=["flat", "rough", "train-flat", "train-rough"])
def test_mixed_kernels_match_plain(terrain, robots):
    """Both kernels at 4096 envs on go1/go2/b1/mini-cheetah interleaved
    (arange % 4) and on train_multi's go1/go2/b1 (runs padded with empty
    slots), on the per-env model, against the plain versions at the bars
    above; two launches give the same bits."""
    dev = _device()
    per_env, st, tau, fk_in = _mixed_case(dev, robots)
    n0 = (K.FK.launches, K.DYNAMICS.launches)
    fk_b, fk_p = K.fk(per_env, fk_in)
    ref_b, ref_p = K.fk_plain(per_env, fk_in)
    torch.testing.assert_close(fk_b, ref_b, rtol=0, atol=1e-5)
    torch.testing.assert_close(fk_p, ref_p, rtol=0, atol=1e-5)
    hc, duv, env, inv_s = _rows_b(dev, fk_p, terrain.split("-")[-1])
    args = (per_env, EngineParams(), pack_state_rows(st, tau), fk_b, fk_p,
            hc, duv, env, inv_s)
    got = K.dynamics(*args)
    ref = K.dynamics_plain(*args)
    assert (K.FK.launches, K.DYNAMICS.launches) == (n0[0] + 1, n0[1] + 1)
    lay = K.dyn_out_layout(12)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        torch.testing.assert_close(g[k], r[k], rtol=0, atol=tol.get(k, 1e-5),
                                   msg=k)
    assert torch.equal(got, K.dynamics(*args))
    assert torch.equal(fk_p, K.fk(per_env, fk_in)[1])


def test_mixed_path_keeps_the_single_robot_bits():
    """Every env go1 through the mixed path of a [go1, b1] stack, 100
    substeps from standing with contacts, is bit-identical to the
    single-robot path on the same inputs."""
    from wtw_tpu_torch.models.multi import stack_models
    dev = _device()
    go1 = load_robot("go1", device=dev)
    stack = stack_models([go1, load_robot("b1", device=dev)])
    per_env = stack.take(np.zeros(B, np.int32))
    hf = flat_heightfield(20.0, 0.5, device=dev)
    q0 = torch.tensor([0.0, 0.8, -1.6] * 4, device=dev).expand(B, 12)
    s0 = PhysicsState(
        base_pos=torch.tensor([0.0, 0.0, 0.32], device=dev).expand(B, 3),
        base_quat=torch.tensor([0.0, 0, 0, 1.0], device=dev).expand(B, 4),
        base_lin_vel=torch.zeros(B, 3, device=dev),
        base_ang_vel=torch.zeros(B, 3, device=dev), joint_q=q0.clone(),
        joint_qd=torch.zeros(B, 12, device=dev))
    ones, zeros = torch.ones(B, device=dev), torch.zeros(B, device=dev)
    a = b = s0
    for _ in range(100):
        ta = 20.0 * (q0 - a.joint_q) - 0.5 * a.joint_qd
        tb = 20.0 * (q0 - b.joint_q) - 0.5 * b.joint_qd
        a, ia = physics_step_batched(go1, hf, EngineParams(), a, ta, ones,
                                     zeros)
        b, ib = physics_step_batched(per_env, hf, EngineParams(), b, tb, ones,
                                     zeros)
    for f in ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
              "joint_q", "joint_qd"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ia.foot_forces, ib.foot_forces)
    assert float(ia.total_normal_force.min()) > 10.0
