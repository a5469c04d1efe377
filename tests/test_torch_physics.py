"""Parity of the port's physics (wtw_tpu_torch.physics, plain PyTorch
versions on the CPU) against the JAX package.

Inputs are drawn with numpy from a seed and fed to both sides. The JAX
side runs un-jitted (`jax.disable_jit()`) on its XLA path, which is its own
plain reference of the Pallas kernels; a jit of the batched engine takes
minutes on the CPU, the op-by-op run seconds. Tolerances: the JAX repo's
own bars (tests/test_physics_batched.py: state 2e-4, contact forces 200x
that, FK 1e-5); both sides are float32 with different summation orders.

The last tests build the CUDA sources as plain C++ (the kernels' bodies
compile without nvcc, see csrc/wtw_model.cuh) and hold them against the
plain versions, so the kernels' arithmetic is checked on the CPU too.

The ceiling tests put Go2 (51 spheres) under a rough overhead field low
enough that some spheres touch it, and assert that they do, so the
ceiling contact pass cannot pass vacuously.
"""
import ctypes
import dataclasses
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.physics import EngineParams as JaxEngineParams
from wtw_tpu.physics import PhysicsState as JaxPhysicsState
from wtw_tpu.physics import flat_heightfield as jax_flat_heightfield
from wtw_tpu.physics.batched import _Static
from wtw_tpu.physics.batched import _hf_height as jax_hf_height
from wtw_tpu.physics.batched import fk_core as jax_fk_core
from wtw_tpu.physics.batched import physics_step_batched as jax_step
from wtw_tpu.physics.batched import sphere_pos_core as jax_sphere_pos_core
from wtw_tpu.physics.heightfield import height_at as jax_height_at
from wtw_tpu.physics.heightfield import height_min3 as jax_height_min3
from wtw_tpu.physics.heightfield import make_heightfield as jax_make_hf
from wtw_tpu.utils import quat as jq

from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.models.robot import ARRAY_FIELDS
from wtw_tpu_torch.physics import (EngineParams, PhysicsState,
                                   flat_heightfield, make_heightfield,
                                   physics_step_batched)
from wtw_tpu_torch.physics import kernels as K
from wtw_tpu_torch.physics.batched import (_hf_height, _hf_rows, fk_core,
                                           pack_state_rows, sphere_pos_core)
from wtw_tpu_torch.physics.heightfield import height_at, height_min3
from wtw_tpu_torch.physics.linalg import cholesky_solve
from wtw_tpu_torch.utils import quat as tq

STATE_FIELDS = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                "joint_q", "joint_qd")
INFO_FIELDS = ("foot_forces", "foot_positions", "foot_velocities",
               "thigh_contact", "calf_contact", "base_contact",
               "total_normal_force")


def random_state(rng, B, z=0.35):
    """Near-standing random states (tests/test_physics_batched.py:19-39)."""
    q = rng.randn(B, 4) * 0.1 + np.array([0.0, 0.0, 0.0, 1.0])
    f = lambda x: np.asarray(x, np.float32)
    return dict(
        base_pos=f(np.concatenate([rng.uniform(-1, 1, (B, 2)),
                                   z + rng.uniform(-0.05, 0.1, (B, 1))], 1)),
        base_quat=f(q / np.linalg.norm(q, axis=1, keepdims=True)),
        base_lin_vel=f(0.5 * rng.randn(B, 3)),
        base_ang_vel=f(0.5 * rng.randn(B, 3)),
        joint_q=f(np.tile([0.0, 0.8, -1.6] * 4, (B, 1))
                  + 0.1 * rng.randn(B, 12)),
        joint_qd=f(0.5 * rng.randn(B, 12)))


@pytest.mark.parametrize("name,dims", [("go1", (13, 12, 18, 39)),
                                       ("go2", (13, 12, 18, 51)),
                                       ("b1", (13, 12, 18, 31)),
                                       ("mini_cheetah", (13, 12, 18, 52))])
def test_load_robot_arrays_match_exactly(name, dims):
    jm, tm = jax_load_robot(name), load_robot(name)
    assert (tm.nb, tm.nj, tm.nv, tm.P) == dims
    assert tm.parent_static == jm.parent_static
    assert tm.joint_names == jm.joint_names
    assert tm.body_names == jm.body_names
    for name in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
        np.testing.assert_array_equal(tm.static[name],
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


def _quats(rng, n):
    q = rng.randn(n, 4)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


QUAT_CASES = {
    "quat_mul": lambda m, a, b, v, s: m.quat_mul(a, b),
    "quat_conjugate": lambda m, a, b, v, s: m.quat_conjugate(a),
    "quat_rotate": lambda m, a, b, v, s: m.quat_rotate(a, v),
    "quat_rotate_inverse": lambda m, a, b, v, s: m.quat_rotate_inverse(a, v),
    "quat_from_angle_axis": lambda m, a, b, v, s: m.quat_from_angle_axis(
        s, v / (v * v).sum(-1, keepdims=True) ** 0.5),
    "quat_to_matrix": lambda m, a, b, v, s: m.quat_to_matrix(a),
    "quat_integrate": lambda m, a, b, v, s: m.quat_integrate(a, v, 0.005),
    "quat_yaw": lambda m, a, b, v, s: m.quat_yaw(a),
    "yaw_quat": lambda m, a, b, v, s: m.yaw_quat(a),
    "quat_apply_yaw": lambda m, a, b, v, s: m.quat_apply_yaw(a, v),
    "quat_from_euler_xyz": lambda m, a, b, v, s: m.quat_from_euler_xyz(
        s, 0.5 * s, -s),
    "quat_to_euler_xyz": lambda m, a, b, v, s: m.quat_to_euler_xyz(a),
    "wrap_to_pi": lambda m, a, b, v, s: m.wrap_to_pi(4.0 * s),
    "skew": lambda m, a, b, v, s: m.skew(v),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_op_matches_jax(name):
    """xyzw quaternion helpers, elementwise float32: atol 1e-6."""
    rng = np.random.RandomState(0)
    a, b = _quats(rng, 32), _quats(rng, 32)
    v = rng.randn(32, 3).astype(np.float32)
    s = rng.uniform(-3, 3, 32).astype(np.float32)
    fn = QUAT_CASES[name]
    got = fn(tq, *map(torch.from_numpy, (a, b, v, s)))
    ref = fn(jq, *map(jnp.asarray, (a, b, v, s)))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def test_fk_and_sphere_positions_match_jax():
    """fk_core + sphere_pos_core at the FK bar, atol 1e-5."""
    rng = np.random.RandomState(5)
    B = 16
    st = random_state(rng, B)
    jm = jax_load_robot("go1")
    jst = _Static(jm, JaxEngineParams())
    cols = lambda a: [jnp.asarray(a[:, i]) for i in range(a.shape[1])]
    with jax.disable_jit():
        bp, bq, an, ax = jax_fk_core(jst, cols(st["base_pos"]),
                                     cols(st["base_quat"]),
                                     cols(st["joint_q"]))
        xp, _ = jax_sphere_pos_core(jst, bp, bq)
    tm = load_robot("go1")
    tbp, tbq, tan, tax = fk_core(tm, *(torch.from_numpy(st[k]) for k in (
        "base_pos", "base_quat", "joint_q")))
    txp, _ = sphere_pos_core(tm, tbp, tbq)
    bc = lambda x: np.broadcast_to(np.asarray(x), (B,))
    for ref, got in ((bp, tbp), (bq, tbq), (an, tan), (ax, tax)):
        for i, comps in enumerate(ref):
            for k, c in enumerate(comps):
                np.testing.assert_allclose(got[:, i, k].numpy(), bc(c),
                                           atol=1e-5)
    for k in range(3):
        np.testing.assert_allclose(txp[..., k].numpy().T, np.asarray(xp[k]),
                                   atol=1e-5)


@pytest.mark.parametrize("terrain", ["flat", "rough"])
def test_physics_step_batched_matches_jax(terrain):
    """One substep with payload, CoM offset and an external acceleration:
    state at 2e-4, contact forces and foot kinematics at 200x that."""
    rng = np.random.RandomState(0)
    B = 8
    st = random_state(rng, B)
    tau = (3.0 * rng.randn(B, 12)).astype(np.float32)
    fric = np.linspace(0.3, 2.0, B).astype(np.float32)
    rest = np.linspace(0.0, 0.4, B).astype(np.float32)
    pay = np.linspace(-0.5, 2.0, B).astype(np.float32)
    com = np.tile([[0.01, -0.005, 0.002]], (B, 1)).astype(np.float32)
    ea = np.array([0.1, -0.2, 0.3], np.float32)
    hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
    if terrain == "flat":
        jhf, thf = jax_flat_heightfield(20.0, 0.5), flat_heightfield(20.0, 0.5)
    else:
        jhf = jax_make_hf(jnp.asarray(hts), 0.25, [-10.0, -10.0])
        thf = make_heightfield(hts, 0.25, [-10.0, -10.0])
    with jax.disable_jit():
        js, ji = jax_step(
            jax_load_robot("go1"), jhf, JaxEngineParams(),
            JaxPhysicsState(**{k: jnp.asarray(v) for k, v in st.items()}),
            jnp.asarray(tau), jnp.asarray(fric), jnp.asarray(rest),
            payload_mass=jnp.asarray(pay), com_offset=jnp.asarray(com),
            external_accel=jnp.asarray(ea), backend="xla")
    T = torch.from_numpy
    ts, ti = physics_step_batched(
        load_robot("go1"), thf, EngineParams(),
        PhysicsState(**{k: T(v) for k, v in st.items()}), T(tau), T(fric),
        T(rest), payload_mass=T(pay), com_offset=T(com), external_accel=T(ea))
    for n in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, n).numpy(),
                                   np.asarray(getattr(js, n)), atol=2e-4,
                                   err_msg=n)
    for n in INFO_FIELDS:
        np.testing.assert_allclose(getattr(ti, n).numpy(),
                                   np.asarray(getattr(ji, n)),
                                   atol=2e-4 * 200.0, err_msg=n)
    assert float(ti.total_normal_force.max()) > 10.0   # contacts exercised


def test_multistep_stability():
    """100 substeps from standing under PD control stay finite and near
    standing height (test_batched_multistep_stability)."""
    B = 4
    model = load_robot("go1")
    hf = flat_heightfield(20.0, 0.5)
    q0 = torch.tensor([0.0, 0.8, -1.6] * 4).expand(B, 12)
    s = PhysicsState(base_pos=torch.tensor([0.0, 0.0, 0.32]).expand(B, 3),
                     base_quat=torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(B, 4),
                     base_lin_vel=torch.zeros(B, 3),
                     base_ang_vel=torch.zeros(B, 3), joint_q=q0.clone(),
                     joint_qd=torch.zeros(B, 12))
    for _ in range(100):
        tau = 20.0 * (q0 - s.joint_q) - 0.5 * s.joint_qd
        s, _ = physics_step_batched(model, hf, EngineParams(), s, tau,
                                    torch.ones(B), torch.zeros(B))
    assert torch.isfinite(s.base_pos).all()
    assert bool((s.base_pos[:, 2] > 0.15).all())
    assert bool((s.base_pos[:, 2] < 0.45).all())


def test_cholesky_solve_matches_numpy():
    """Batched env-minor Cholesky vs numpy's solve, float32: rtol 1e-4."""
    rng = np.random.RandomState(0)
    X = rng.randn(6, 18, 18)
    A = (X @ X.transpose(0, 2, 1) + 18 * np.eye(18)).astype(np.float32)
    b = rng.randn(6, 18).astype(np.float32)
    x = cholesky_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])
    np.testing.assert_allclose(x, ref[..., 0], rtol=1e-4, atol=1e-5)


def test_heightfield_matches_jax():
    """Packed corner rows, flat detection and bilinear height: atol 1e-6."""
    rng = np.random.RandomState(1)
    hts = (0.1 * rng.randn(30, 40)).astype(np.float32)
    jhf = jax_make_hf(jnp.asarray(hts), 0.1, [-1.5, -2.0])
    thf = make_heightfield(hts, 0.1, [-1.5, -2.0])
    np.testing.assert_array_equal(thf.corners.numpy(), np.asarray(jhf.corners))
    assert thf.is_flat is False and flat_heightfield().is_flat is True
    xy = rng.uniform(-2.5, 2.5, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(height_at(thf, torch.from_numpy(xy)).numpy(),
                               np.asarray(jax_height_at(jhf, jnp.asarray(xy))),
                               atol=1e-6)


def test_height_min3_matches_jax():
    """Min of the 3 nearest grid samples (the raycast semantics): exact."""
    rng = np.random.RandomState(2)
    hts = (0.1 * rng.randn(30, 40)).astype(np.float32)
    jhf = jax_make_hf(jnp.asarray(hts), 0.1, [-1.5, -2.0])
    thf = make_heightfield(hts, 0.1, [-1.5, -2.0])
    xy = rng.uniform(-2.5, 2.5, (8, 16, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        height_min3(thf, torch.from_numpy(xy)).numpy(),
        np.asarray(jax_height_min3(jhf, jnp.asarray(xy))))


GO2_Q = [0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5]


def _go2_ceiling_case(B=8):
    """Go2 near standing over rough ground under a rough ceiling at
    0.36 +- 0.02 m, low enough for the base's top spheres (0.077 m above
    a base at ~0.33 m) to touch it. Open sky (the 1e6 m sentinel of
    `terrain/parkour.py`) covers y < 0 and blends into the ceiling across
    one cell, so some envs stand under open sky and some under the edge."""
    rng = np.random.RandomState(4)
    st = random_state(rng, B, z=0.30)
    st["joint_q"] = (np.tile(GO2_Q, (B, 1))
                     + 0.1 * rng.randn(B, 12)).astype(np.float32)
    tau = (3.0 * rng.randn(B, 12)).astype(np.float32)
    fric = np.linspace(0.5, 1.25, B).astype(np.float32)
    ground = (0.03 * np.random.RandomState(3).randn(80, 80)).astype(
        np.float32)
    ceil = (0.36 + 0.02 * np.random.RandomState(5).randn(80, 80)).astype(
        np.float32)
    ceil[:, :40] = 1e6
    return st, tau, fric, ground, ceil


def _assert_caches_equal(jc, tc):
    assert sorted(jc) == sorted(tc) == ["c", "g"]
    for part in ("g", "c"):
        u0, v0, hc = tc[part]
        np.testing.assert_array_equal(u0.numpy(), np.asarray(jc[part][0]))
        np.testing.assert_array_equal(v0.numpy(), np.asarray(jc[part][1]))
        for k in range(4):
            np.testing.assert_array_equal(hc[k].numpy(),
                                          np.asarray(jc[part][2][k]))


@pytest.mark.parametrize("mode", ["gather", "cached", "chained"])
def test_physics_step_with_ceiling_matches_jax(mode):
    """Go2 under a rough ceiling, one substep ("gather"), or a substep that
    returns the corner-row cache and a second one that reuses it
    ("cached"), or that reuses it and returns a new one ("chained": its
    rows come from the cache it was given); the caches must agree too.
    Bars of tests/test_physics_batched.py:65-76: state 2e-4, contact forces
    and foot kinematics 200x that."""
    B = 8
    st, tau, fric, ground, ceil = _go2_ceiling_case(B)
    rest = np.zeros(B, np.float32)
    jargs = (jax_make_hf(jnp.asarray(ground), 0.25, [-10.0, -10.0]),
             JaxEngineParams())
    jceil = jax_make_hf(jnp.asarray(ceil), 0.25, [-10.0, -10.0])
    thf = make_heightfield(ground, 0.25, [-10.0, -10.0])
    tceil = make_heightfield(ceil, 0.25, [-10.0, -10.0])
    T = torch.from_numpy
    jm, tm = jax_load_robot("go2"), load_robot("go2")
    js = JaxPhysicsState(**{k: jnp.asarray(v) for k, v in st.items()})
    ts = PhysicsState(**{k: T(v) for k, v in st.items()})
    with jax.disable_jit():
        jout = jax_step(jm, *jargs, js, jnp.asarray(tau), jnp.asarray(fric),
                        jnp.asarray(rest), hf_ceiling=jceil, backend="xla",
                        return_hf_cache=mode != "gather")
    tout = physics_step_batched(tm, thf, EngineParams(), ts, T(tau), T(fric),
                                T(rest), hf_ceiling=tceil,
                                return_hf_cache=mode != "gather")
    if mode != "gather":
        jc, tc = jout[2], tout[2]
        _assert_caches_equal(jc, tc)
        js, ts = jout[0], tout[0]
        if mode == "chained":
            # moved 0.6 m (2.4 cells) from where the cache was gathered,
            # so that rows from the cache and a fresh gather differ
            shift = np.array([0.6, 0.0, 0.0], np.float32)
            js = js.replace(base_pos=js.base_pos + shift)
            ts = dataclasses.replace(ts, base_pos=ts.base_pos + T(shift))
        with jax.disable_jit():
            jout = jax_step(jm, *jargs, js, jnp.asarray(tau),
                            jnp.asarray(fric), jnp.asarray(rest),
                            hf_ceiling=jceil, backend="xla", hf_cache=jc,
                            return_hf_cache=mode == "chained")
        tout = physics_step_batched(tm, thf, EngineParams(), ts, T(tau),
                                    T(fric), T(rest), hf_ceiling=tceil,
                                    hf_cache=tc,
                                    return_hf_cache=mode == "chained")
    if mode == "chained":
        _assert_caches_equal(jout[2], tout[2])
    (js, ji), (ts, ti) = jout[:2], tout[:2]
    for n in STATE_FIELDS:
        np.testing.assert_allclose(getattr(ts, n).numpy(),
                                   np.asarray(getattr(js, n)), atol=2e-4,
                                   err_msg=n)
    for n in INFO_FIELDS:
        np.testing.assert_allclose(getattr(ti, n).numpy(),
                                   np.asarray(getattr(ji, n)),
                                   atol=2e-4 * 200.0, err_msg=n)
    # the ceiling was touched: a sphere's top reaches above the ceiling
    fk_in = torch.cat([ts.base_pos, ts.base_quat, ts.joint_q], 1).T
    _, fk_p = K.fk_plain(tm, fk_in.contiguous())
    ch = _hf_height(tceil, fk_p[0], fk_p[1])
    assert int((fk_p[2] + tm.sph_radius[:, None] > ch).sum()) > 0


def test_ceiling_height_matches_jax():
    """Bilinear ceiling height under the spheres, open-sky cells blended
    at the edge: exact."""
    st, _, _, _, ceil = _go2_ceiling_case()
    tm = load_robot("go2")
    fk_in = torch.from_numpy(np.concatenate(
        [st["base_pos"], st["base_quat"], st["joint_q"]], 1).T.copy())
    _, fk_p = K.fk_plain(tm, fk_in)
    jceil = jax_make_hf(jnp.asarray(ceil), 0.25, [-10.0, -10.0])
    got = _hf_height(make_heightfield(ceil, 0.25, [-10.0, -10.0]),
                     fk_p[0], fk_p[1])
    with jax.disable_jit():
        ref = jax_hf_height(jceil, jnp.asarray(fk_p[0].numpy()),
                            jnp.asarray(fk_p[1].numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_model_struct_rejects_oversized_robot():
    import dataclasses
    model = load_robot("go1")
    big = dict(model.static)
    big["sph_body"] = np.zeros(K.MAX_SPHERES + 1, np.int32)
    too_many = dataclasses.replace(model, static=big)
    with pytest.raises(ValueError):
        K.model_struct(too_many, EngineParams())


@pytest.mark.parametrize("robot", ["go1", "go2", "b1", "mini_cheetah"])
def test_model_struct_level_order_is_topological(robot):
    """The kernels walk the tree level by level: every body's parent lies in
    the level before its own, each level lists each of its parents'
    children together (child_off, n_child), every body appears once, and
    each body's ancestor mask holds exactly its ancestor-or-self dofs."""
    model = load_robot(robot)
    m = K.model_struct(model, EngineParams())
    parent = [int(p) for p in model.static["parent"]]
    levels = [list(m.lvl_body[m.lvl_off[l]:m.lvl_off[l + 1]])
              for l in range(m.n_lvl)]
    assert levels[0] == [0]
    assert sorted(b for lv in levels for b in lv) == list(range(model.nb))
    for l in range(1, m.n_lvl):
        for b in levels[l]:
            assert parent[b] in levels[l - 1], (b, l)
    order = list(m.lvl_body[:model.nb])
    for b in range(model.nb):
        kids = order[m.child_off[b]:m.child_off[b] + m.n_child[b]]
        assert sorted(kids) == [c for c in range(1, model.nb)
                                if parent[c] == b], b
    # every robot: the base, then 4 hips, 4 thighs, 4 calves
    assert [len(lv) for lv in levels] == [1, 4, 4, 4]
    anc = model.static["anc"]
    for b in range(model.nb):
        assert m.anc_mask[b] == sum(1 << d for d in range(model.nv)
                                    if anc[b, d] > 0.5)


# ---------------------------------------------------------------------------
# the CUDA sources, built as plain C++, against the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources")
    so = str(tmp_path_factory.mktemp("host_kernels") / "libwtw_host.so")
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                    "-fPIC", "-o", so]
                   + [os.path.join(K.CSRC, s) for s in K.SOURCES],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wtw_model_bytes.restype = ci
    lib.wtw_fk_host.argtypes = [vp] * 4 + [ci]
    lib.wtw_dynamics_host.argtypes = [vp] * 8 + [cf, vp, ci]
    lib.wtw_fk_multi_host.argtypes = [vp, vp, vp, ci] + [vp] * 3 + [ci]
    lib.wtw_dynamics_multi_host.argtypes = ([vp, vp, vp, ci] + [vp] * 7
                                            + [cf, vp, ci])
    lib.wtw_set_lane_order.argtypes = [ci]
    lib.wtw_set_lane_order.restype = None
    for fn in (lib.wtw_fk_info, lib.wtw_dynamics_info,
               lib.wtw_fk_multi_info, lib.wtw_dynamics_multi_info):
        fn.argtypes = [ctypes.POINTER(ci)]
        fn.restype = ci
    assert lib.wtw_model_bytes() == ctypes.sizeof(K.WtwModel)
    return lib


def test_kernel_teams_fit_a_warp_and_blocks_fit_an_sm(host_kernels):
    """Each kernel's team divides a warp (a team syncs alone), its block is
    whole warps, and a block's shared memory fits the 227 KB an H100 block
    may use; kernel B's fits twice in an SM's 228 KB (two blocks, 16 warps,
    per SM), kernel A's static shared memory stays under 48 KB."""
    info = {}
    for name, fn in (("fk", host_kernels.wtw_fk_info),
                     ("dynamics", host_kernels.wtw_dynamics_info)):
        a = (ctypes.c_int * 4)()
        assert fn(a) == 0
        lanes, envs, smem = a[0], a[1], a[2]
        assert 32 % lanes == 0 and (lanes * envs) % 32 == 0, name
        info[name] = smem
    assert info["fk"] <= 48 * 1024
    assert 2 * (info["dynamics"] + 1024) <= 228 * 1024


@pytest.fixture(params=["forward", "reverse"])
def lane_order(request, host_kernels):
    """The host build runs each phase of a team lane after lane; in reverse
    order a phase that reads another lane's write of the same phase (a
    missing sync) gives other results than in forward order."""
    host_kernels.wtw_set_lane_order(int(request.param == "reverse"))
    yield request.param
    host_kernels.wtw_set_lane_order(0)


# base height of the host-build cases: a little below each robot's standing
# height at its preset's default pose (the lowest sphere's bottom 0.32 m
# below the base for go1, 0.52 m for b1, 0.47 m for the mini-cheetah), so
# some spheres of most envs are in the ground
HOST_Z = {"go1": 0.30, "b1": 0.49, "mini_cheetah": 0.45}


def _host_inputs(B=64, robot="go1"):
    rng = np.random.RandomState(1)
    model, params = load_robot(robot), EngineParams()
    st = PhysicsState(**{k: torch.from_numpy(v) for k, v in
                         random_state(rng, B, z=HOST_Z[robot]).items()})
    tau = torch.from_numpy((3.0 * rng.randn(B, 12)).astype(np.float32))
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    raw = bytearray(bytes(K.model_struct(model, params)))
    mbuf = (ctypes.c_char * len(raw)).from_buffer(raw)
    return model, params, st, tau, fk_in, raw, mbuf


@pytest.mark.parametrize("robot,B", [("go1", 64), ("go1", 61), ("b1", 64),
                                     ("mini_cheetah", 64)],
                         ids=["64", "61", "b1-64", "mini_cheetah-64"])
def test_kernel_a_source_matches_plain(host_kernels, lane_order, robot, B):
    """csrc/fk.cu built for the host vs fk_plain: atol 1e-5 (the FK bar),
    lanes in both orders, a ragged B (61: not a multiple of the 8 envs of
    a block), and the B1 (31 spheres) and mini-cheetah (52) models."""
    model, params, st, tau, fk_in, raw, mbuf = _host_inputs(B, robot)
    ref_b, ref_p = K.fk_plain(model, fk_in)
    got_b, got_p = torch.empty_like(ref_b), torch.empty_like(ref_p)
    host_kernels.wtw_fk_host(ctypes.addressof(mbuf), fk_in.data_ptr(),
                             got_b.data_ptr(), got_p.data_ptr(),
                             fk_in.shape[1])
    np.testing.assert_allclose(got_b.numpy(), ref_b.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), ref_p.numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "robot,terrain,B",
    [("go1", "flat", 64), ("go1", "rough", 64), ("go1", "rough", 61),
     ("b1", "flat", 64), ("b1", "rough", 64), ("mini_cheetah", "flat", 64),
     ("mini_cheetah", "rough", 64)],
    ids=["flat-64", "rough-64", "rough-61", "b1-flat-64", "b1-rough-64",
         "mini_cheetah-flat-64", "mini_cheetah-rough-64"])
def test_kernel_b_source_matches_plain(host_kernels, lane_order, robot,
                                       terrain, B):
    """csrc/dynamics.cu built for the host vs dynamics_plain at the bars of
    tests/test_physics_batched.py:157-159 (lin vel 1e-4, joint qd 1e-3,
    foot forces 1e-1), positions at 1e-5; lanes in both orders, a ragged B
    (61: not a multiple of the 8 envs of a block), and the B1 (55.7 kg, 31
    spheres) and mini-cheetah (52 spheres) models on flat and rough
    ground."""
    model, params, st, tau, fk_in, raw, mbuf = _host_inputs(B, robot)
    B = fk_in.shape[1]
    fk_b, fk_p = K.fk_plain(model, fk_in)
    if terrain == "flat":
        hf = flat_heightfield(20.0, 0.5)
    else:
        hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
        hf = make_heightfield(hts, 0.25, [-10.0, -10.0])
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    hc, duv = hc.contiguous(), duv.contiguous()
    env = torch.cat([torch.linspace(0.3, 2.0, B)[None],
                     torch.linspace(0.0, 0.4, B)[None],
                     torch.linspace(-0.5, 2.0, B)[None],
                     torch.tensor([[0.01], [-0.005], [0.002]]).expand(3, B),
                     torch.tensor([[0.1], [-0.2], [0.3]]).expand(3, B)],
                    0).contiguous()
    srows = pack_state_rows(st, tau)
    args = (srows, fk_b, fk_p, hc, duv, env, 1.0 / hf.horizontal_scale)
    ref = K.dynamics_plain(model, params, *args)
    got = torch.empty_like(ref)
    host_kernels.wtw_dynamics_host(
        ctypes.addressof(mbuf), *(a.data_ptr() for a in args[:5]), None,
        args[5].data_ptr(), args[6], got.data_ptr(), B)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                   atol=tol.get(k, 1e-5), err_msg=k)
    assert float(r["total_normal_force"].max()) > 10.0


def test_kernel_b_ceiling_source_matches_plain(host_kernels, lane_order):
    """csrc/dynamics.cu's ceiling pass built for the host vs dynamics_plain
    with `ceil_h`, Go2 under the rough ceiling of _go2_ceiling_case at 64
    envs, lanes in both orders: the bars of
    test_kernel_b_source_matches_plain."""
    B = 64
    st, tau, fric, ground, ceil = _go2_ceiling_case(B)
    model, params = load_robot("go2"), EngineParams()
    T = torch.from_numpy
    srows = pack_state_rows(PhysicsState(**{k: T(v) for k, v in st.items()}),
                            T(tau))
    fk_in = srows[:7 + 12].contiguous()
    fk_b, fk_p = K.fk_plain(model, fk_in)
    hf = make_heightfield(ground, 0.25, [-10.0, -10.0])
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    ceil_h = _hf_height(make_heightfield(ceil, 0.25, [-10.0, -10.0]),
                        fk_p[0], fk_p[1]).contiguous()
    env = torch.cat([T(fric)[None], torch.zeros(8, B)], 0).contiguous()
    ins = (srows, fk_b, fk_p, hc.contiguous(), duv.contiguous(), ceil_h, env)
    ref = K.dynamics_plain(model, params, *ins[:5], env, 4.0, ceil_h=ceil_h)
    got = torch.empty_like(ref)
    raw = bytearray(bytes(K.model_struct(model, params)))
    mbuf = (ctypes.c_char * len(raw)).from_buffer(raw)
    host_kernels.wtw_dynamics_host(ctypes.addressof(mbuf),
                                   *(a.data_ptr() for a in ins), 4.0,
                                   got.data_ptr(), B)
    lay = K.dyn_out_layout(model.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    tol = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
           "foot_forces": 1e-1, "thigh_contact": 1e-1, "calf_contact": 1e-1,
           "base_contact": 1e-1, "total_normal_force": 1e-1,
           "foot_velocities": 1e-4}
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                   atol=tol.get(k, 1e-5), err_msg=k)
    touching = fk_p[2] + model.sph_radius[:, None] > ceil_h
    assert int(touching.sum()) > 0
    # the ceiling changes the result: the same inputs without it differ
    free = K.dynamics_plain(model, params, *ins[:5], env, 4.0)
    assert float((free - ref).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# mixed-robot batches: the kernels' slot-table path, built for the host
# ---------------------------------------------------------------------------

MIX = ("go1", "go2", "b1", "mini_cheetah")
# train_multi's default mix as chip_smoke.py trains it
TRAIN_MIX = ("go1", "go2", "b1")
MIX_Z = {"go1": 0.30, "go2": 0.30, "b1": 0.49, "mini_cheetah": 0.45}
DYN_HOST_TOL = {"base_lin_vel": 1e-4, "joint_qd": 1e-3, "base_ang_vel": 1e-3,
                "foot_forces": 1e-1, "thigh_contact": 1e-1,
                "calf_contact": 1e-1, "base_contact": 1e-1,
                "total_normal_force": 1e-1, "foot_velocities": 1e-4}


def _mixed_inputs(B, robots=MIX, assignment=None, seed=2):
    """The per-env model of a stack of `robots`, env i robot
    `assignment[i]` (arange % R by default), near-standing random states at
    each robot's height, and the host arrays of the slot table and the R
    model structs."""
    from wtw_tpu_torch.models.multi import robot_of, stack_models
    rng = np.random.RandomState(seed)
    stack, params = stack_models([load_robot(r) for r in robots]), \
        EngineParams()
    a = (np.arange(B) % len(robots) if assignment is None
         else np.asarray(assignment))
    robot = torch.from_numpy(a.astype(np.int32))
    st = random_state(rng, B)
    st["base_pos"][:, 2] += np.array([MIX_Z[robots[r]] - 0.35 for r in a],
                                     np.float32)
    st = PhysicsState(**{k: torch.from_numpy(v) for k, v in st.items()})
    tau = torch.from_numpy((3.0 * rng.randn(B, 12)).astype(np.float32))
    fk_in = torch.cat([st.base_pos, st.base_quat, st.joint_q], 1).T.contiguous()
    raw = bytearray(b"".join(bytes(K.model_struct(robot_of(stack, r), params))
                             for r in range(len(robots))))
    mbuf = (ctypes.c_char * len(raw)).from_buffer(raw)
    slot_env, slot_robot = K.slot_table(robot, len(robots))
    return stack.take(a), params, robot, st, tau, fk_in, (raw, mbuf), \
        (slot_env, slot_robot)


def _fk_multi_host(lib, mbuf, slots, fk_in, nb, nj, P):
    B = fk_in.shape[1]
    fk_b, fk_p = torch.empty(nb * 7 + nj * 6, B), torch.empty(3, P, B)
    rc = lib.wtw_fk_multi_host(
        ctypes.addressof(mbuf), slots[0].data_ptr(), slots[1].data_ptr(),
        slots[0].numel(), fk_in.data_ptr(), fk_b.data_ptr(), fk_p.data_ptr(),
        B)
    assert rc == 0
    return fk_b, fk_p


def _dyn_multi_host(lib, mbuf, slots, ins, inv_s, n_out):
    B = ins[0].shape[1]
    out = torch.empty(n_out, B)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.wtw_dynamics_multi_host(
        ctypes.addressof(mbuf), slots[0].data_ptr(), slots[1].data_ptr(),
        slots[0].numel(), *(ptr(t) for t in ins), inv_s, out.data_ptr(), B)
    assert rc == 0
    return out


def _kernel_b_rows(fk_p, terrain, B):
    """Corner rows, offsets and env rows of kernel B's random cases."""
    if terrain == "flat":
        hf = flat_heightfield(20.0, 0.5)
    else:
        hts = (0.06 * np.random.RandomState(3).randn(80, 80)).astype(np.float32)
        hf = make_heightfield(hts, 0.25, [-10.0, -10.0])
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    env = torch.cat([torch.linspace(0.3, 2.0, B)[None],
                     torch.linspace(0.0, 0.4, B)[None],
                     torch.linspace(-0.5, 2.0, B)[None],
                     torch.tensor([[0.01], [-0.005], [0.002]]).expand(3, B),
                     torch.tensor([[0.1], [-0.2], [0.3]]).expand(3, B)],
                    0).contiguous()
    return hc.contiguous(), duv.contiguous(), env, 1.0 / hf.horizontal_scale


def test_slot_table_groups_envs_by_robot():
    """Each robot's envs, in env order, padded with -1 to a multiple of
    SLOT_GROUP, which both kernels' envs per block divide: every block of
    either kernel holds envs of one robot."""
    a = np.array([2, 0, 0, 2, 1, 0, 2, 2, 2] * 3, np.int32)
    slot_env, slot_robot = K.slot_table(torch.from_numpy(a), 4)
    se, sr = slot_env.numpy(), slot_robot.numpy()
    assert len(se) % K.SLOT_GROUP == 0 and len(se) == len(sr)
    for r in range(4):
        assert list(se[(sr == r) & (se >= 0)]) == list(np.flatnonzero(a == r))
        assert (sr == r).sum() % K.SLOT_GROUP == 0
    assert sorted(se[se >= 0]) == list(range(len(a)))
    # robot 3 has no env and no slot
    assert (sr == 3).sum() == 0


def test_wrappers_take_a_per_env_model_not_a_bare_stack():
    """Both wrappers read a mixed batch from a per-env model
    (`stack.take(index)`, as the env builds it) and refuse the bare stack,
    on the CPU as on the card; the per-env model's plain result is each
    robot's own for its envs, at the host build's bars."""
    per_env, params, robot, st, tau, fk_in, _, _ = _mixed_inputs(8)
    with pytest.raises(ValueError, match="per-env model"):
        K.fk(per_env.stack, fk_in)
    fk_b, fk_p = K.fk(per_env, fk_in)
    hc, duv, env, inv_s = _kernel_b_rows(fk_p, "flat", 8)
    args = (params, pack_state_rows(st, tau), fk_b, fk_p, hc, duv, env,
            inv_s)
    with pytest.raises(ValueError, match="per-env model"):
        K.dynamics(per_env.stack, *args)
    out = K.dynamics(per_env, *args)
    go2 = load_robot("go2")
    i = torch.from_numpy(np.flatnonzero(robot.numpy() == 1))
    one_b, one_p = K.fk(go2, fk_in[:, i].contiguous())
    assert torch.equal(one_b, fk_b[:, i])
    assert torch.equal(one_p, fk_p[:, :go2.P, i])
    sub = lambda t: t[..., i].contiguous()
    one = K.dynamics(go2, params, sub(args[1]), one_b, one_p,
                     sub(hc[:, :go2.P]), sub(duv[:, :go2.P]), sub(env),
                     inv_s)
    lay = K.dyn_out_layout(go2.nj)
    g, r = K.unpack_rows(out[:, i], lay), K.unpack_rows(one, lay)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                   atol=DYN_HOST_TOL.get(k, 1e-5), err_msg=k)


def test_kernel_blocks_fit_the_slot_group(host_kernels):
    """Both kernels' envs per block divide SLOT_GROUP, and the mixed path's
    launch has the single path's shape (one model staged a block)."""
    for single, multi in ((host_kernels.wtw_fk_info,
                           host_kernels.wtw_fk_multi_info),
                          (host_kernels.wtw_dynamics_info,
                           host_kernels.wtw_dynamics_multi_info)):
        a, b = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        assert single(a) == 0 and multi(b) == 0
        assert K.SLOT_GROUP % a[1] == 0
        assert list(a) == list(b)


@pytest.mark.parametrize("B,robots", [(64, MIX), (61, MIX), (61, TRAIN_MIX)],
                         ids=["64", "61", "train-61"])
def test_kernel_a_mixed_source_matches_plain(host_kernels, lane_order, B,
                                             robots):
    """csrc/fk.cu's slot-table path built for the host vs fk_plain on the
    per-env model, go1/go2/b1/mini-cheetah interleaved (arange % 4), at the
    FK bar (1e-5), lanes in both orders, and a ragged B; and train_multi's
    default mix go1/go2/b1 (51 spheres), whose runs of 21/20/20 envs pad to
    32 slots each, so blocks hold empty slots."""
    per_env, params, robot, st, tau, fk_in, (raw, mbuf), slots = \
        _mixed_inputs(B, robots)
    ref_b, ref_p = K.fk_plain(per_env, fk_in)
    got_b, got_p = _fk_multi_host(host_kernels, mbuf, slots, fk_in,
                                  per_env.nb, per_env.nj, per_env.P)
    np.testing.assert_allclose(got_b.numpy(), ref_b.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), ref_p.numpy(), atol=1e-5)


@pytest.mark.parametrize("terrain,B,robots", [
    ("flat", 64, MIX), ("rough", 64, MIX), ("rough", 61, MIX),
    ("flat", 61, TRAIN_MIX), ("rough", 61, TRAIN_MIX)],
    ids=["flat-64", "rough-64", "rough-61", "train-flat-61",
         "train-rough-61"])
def test_kernel_b_mixed_source_matches_plain(host_kernels, lane_order,
                                             terrain, B, robots):
    """csrc/dynamics.cu's slot-table path built for the host vs
    dynamics_plain on the per-env model, go1/go2/b1/mini-cheetah
    interleaved, at the bars of test_kernel_b_source_matches_plain, lanes
    in both orders; and train_multi's go1/go2/b1 mix, whose padded runs
    leave empty slots in blocks. Every robot has envs in contact."""
    per_env, params, robot, st, tau, fk_in, (raw, mbuf), slots = \
        _mixed_inputs(B, robots)
    fk_b, fk_p = K.fk_plain(per_env, fk_in)
    hc, duv, env, inv_s = _kernel_b_rows(fk_p, terrain, B)
    srows = pack_state_rows(st, tau)
    ref = K.dynamics_plain(per_env, params, srows, fk_b, fk_p, hc, duv, env,
                           inv_s)
    got = _dyn_multi_host(host_kernels, mbuf, slots,
                          (srows, fk_b, fk_p, hc, duv, None, env), inv_s,
                          ref.shape[0])
    lay = K.dyn_out_layout(per_env.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                   atol=DYN_HOST_TOL.get(k, 1e-5), err_msg=k)
    fn = r["total_normal_force"][:, 0]
    for k in range(len(robots)):
        assert float(fn[robot == k].max()) > 10.0, robots[k]


def test_kernel_b_mixed_ceiling_source_matches_plain(host_kernels,
                                                     lane_order):
    """The slot-table path's ceiling pass: go2 and the mini-cheetah (whose
    52 spheres pad go2's 51) under the rough ceiling of _go2_ceiling_case,
    against dynamics_plain with `ceil_h`; padded spheres stay out of both
    passes."""
    B = 64
    st, tau, fric, ground, ceil = _go2_ceiling_case(B)
    robots = ("go2", "mini_cheetah")
    per_env, params, robot, _, _, _, (raw, mbuf), slots = _mixed_inputs(
        B, robots=robots)
    T = torch.from_numpy
    srows = pack_state_rows(PhysicsState(**{k: T(v) for k, v in st.items()}),
                            T(tau))
    fk_in = srows[:7 + 12].contiguous()
    fk_b, fk_p = K.fk_plain(per_env, fk_in)
    hf = make_heightfield(ground, 0.25, [-10.0, -10.0])
    hc, duv = _hf_rows(hf, fk_p[0], fk_p[1])
    ceil_h = _hf_height(make_heightfield(ceil, 0.25, [-10.0, -10.0]),
                        fk_p[0], fk_p[1]).contiguous()
    env = torch.cat([T(fric)[None], torch.zeros(8, B)], 0).contiguous()
    ins = (srows, fk_b, fk_p, hc.contiguous(), duv.contiguous(), ceil_h, env)
    ref = K.dynamics_plain(per_env, params, *ins[:5], env, 4.0, ceil_h=ceil_h)
    got = _dyn_multi_host(host_kernels, mbuf, slots, ins, 4.0, ref.shape[0])
    lay = K.dyn_out_layout(per_env.nj)
    g, r = K.unpack_rows(got, lay), K.unpack_rows(ref, lay)
    for k in g:
        np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                   atol=DYN_HOST_TOL.get(k, 1e-5), err_msg=k)
    rad = per_env.sph_radius.T
    touching = fk_p[2] + rad > ceil_h
    assert int(touching[:, robot == 0].sum()) > 0
    assert int(touching[:, robot == 1].sum()) > 0
    assert not bool(touching[rad < 0].any())


def test_mixed_path_keeps_the_single_robot_bits(host_kernels, lane_order):
    """A batch whose every env is go1, through the slot-table path of a
    [go1, mini_cheetah] stack (go1's 39 spheres padded to 52), gives
    bit for bit the outputs of the single-robot path on the same inputs,
    on rough ground: the padded spheres' FK rows sit on the base origin
    and they add nothing to kernel B."""
    B = 61
    per_env, params, robot, st, tau, fk_in, (raw, mbuf), slots = \
        _mixed_inputs(B, robots=("go1", "mini_cheetah"),
                      assignment=np.zeros(B, int))
    go1 = load_robot("go1")
    one = bytearray(bytes(K.model_struct(go1, params)))
    one_buf = (ctypes.c_char * len(one)).from_buffer(one)
    sb, sp = torch.empty(go1.nb * 7 + go1.nj * 6, B), torch.empty(3, 39, B)
    host_kernels.wtw_fk_host(ctypes.addressof(one_buf), fk_in.data_ptr(),
                             sb.data_ptr(), sp.data_ptr(), B)
    mb, mp = _fk_multi_host(host_kernels, mbuf, slots, fk_in, per_env.nb,
                            per_env.nj, per_env.P)
    assert torch.equal(mb, sb) and torch.equal(mp[:, :39], sp)
    assert torch.equal(mp[:, 39:], st.base_pos.T[:, None].expand(3, 13, B))
    srows = pack_state_rows(st, tau)
    hc, duv, env, inv_s = _kernel_b_rows(mp, "rough", B)
    single = torch.empty(sum(n for _, n in K.dyn_out_layout(12)), B)
    hc1, duv1 = hc[:, :39].contiguous(), duv[:, :39].contiguous()
    host_kernels.wtw_dynamics_host(
        ctypes.addressof(one_buf), srows.data_ptr(), sb.data_ptr(),
        sp.data_ptr(), hc1.data_ptr(), duv1.data_ptr(), None, env.data_ptr(),
        inv_s, single.data_ptr(), B)
    mixed = _dyn_multi_host(host_kernels, mbuf, slots,
                            (srows, mb, mp, hc, duv, None, env), inv_s,
                            single.shape[0])
    assert torch.equal(mixed, single)
    assert float(K.unpack_rows(single, K.dyn_out_layout(12))[
        "total_normal_force"].max()) > 10.0


# ---------------------------------------------------------------------------
# analytic cases on the port's per-robot engine
# (the counterparts of tests/test_dynamics_analytic.py)
# ---------------------------------------------------------------------------


def chain_model(n_links, link_len=0.5, mass=1.0, fixed_base=True,
                point_mass=False, inertia=None):
    """n revolute links about +y hanging in -z, com at each link's end
    (tests/test_dynamics_analytic.py:16), built in the port."""
    from wtw_tpu_torch.models.robot import _ancestor_mask, _make
    nb = n_links + 1
    parent = np.arange(-1, n_links).astype(np.int32)
    com = np.tile([0.0, 0.0, -link_len], (nb, 1))
    com[0] = 0.0
    I = inertia if inertia is not None else (1e-9 if point_mass else 0.01)
    m = np.full(nb, mass)
    m[0] = 1.0
    jpos = np.tile([0.0, 0.0, -link_len], (n_links, 1))
    jpos[0] = 0.0
    f32 = lambda x: np.asarray(x, np.float32)
    i32 = lambda x: np.asarray(x, np.int32)
    big = np.full(n_links, 1e9)
    static = dict(
        parent=parent, anc=_ancestor_mask(parent, n_links),
        joint_pos=f32(jpos), joint_quat=f32(np.tile([0, 0, 0, 1.0],
                                                    (n_links, 1))),
        joint_axis=f32(np.tile([0.0, 1.0, 0.0], (n_links, 1))),
        joint_lower=f32(-big), joint_upper=f32(big), effort_limit=f32(big),
        velocity_limit=f32(big), joint_damping=f32(np.zeros(n_links)),
        joint_friction=f32(np.zeros(n_links)), mass=f32(m), com=f32(com),
        inertia=f32(np.tile(np.eye(3) * I, (nb, 1, 1))),
        sph_body=i32([0]), sph_pos=f32(np.zeros((1, 3))),
        sph_radius=f32([0.001]), sph_label=i32([0]), sph_leg=i32([-1]),
        feet_body=i32(np.zeros(4)), feet_pos=f32(np.zeros((4, 3))),
        foot_radius=f32(np.full(4, 0.02)))
    return _make("chain", tuple(f"j{i}" for i in range(n_links)),
                 tuple(f"b{i}" for i in range(nb)), fixed_base, static,
                 torch.device("cpu"))


def _chain_state(q, qd, base_z=3.0, lin=(0.0, 0.0, 0.0), ang=(0.0, 0.0, 0.0)):
    t = lambda x: torch.tensor(x, dtype=torch.float32)
    return PhysicsState(base_pos=t([0.0, 0.0, base_z]),
                        base_quat=t([0.0, 0.0, 0.0, 1.0]),
                        base_lin_vel=t(lin), base_ang_vel=t(ang),
                        joint_q=t(q), joint_qd=t(qd))


def _chain_step(model, dt, gravity=(0.0, 0.0, -9.81)):
    from wtw_tpu_torch.physics.engine import physics_step
    hf = flat_heightfield()
    params = EngineParams(dt=dt, armature=0.0, gravity=gravity)
    return lambda s, tau: physics_step(model, hf, params, s,
                                       torch.as_tensor(tau, dtype=torch.float32),
                                       1.0, 0.0)[0]


def _chain_momenta(model, s, g=9.81):
    """(kinetic + potential energy, linear momentum, angular momentum about
    the world origin) from the port's per-robot FK and each body's com
    velocity."""
    from wtw_tpu_torch.physics.engine import fk
    pos, quat, anchors, axes = fk(model, s.base_pos, s.base_quat, s.joint_q)
    R = tq.quat_to_matrix(quat).double()
    p0 = s.base_pos.double()
    nj = model.nj
    S = torch.zeros(6 + nj, 6, dtype=torch.float64)
    S[0:3, 0:3] = torch.eye(3)
    S[3:6, 3:6] = torch.eye(3)
    S[6:, :3] = axes.double()
    S[6:, 3:] = torch.linalg.cross(anchors.double() - p0, axes.double())
    u = torch.cat([s.base_ang_vel, s.base_lin_vel, s.joint_qd]).double()
    if model.fixed_base:
        u[:6] = 0.0
    V = (model.anc.double()[:, :, None] * S[None] * u[None, :, None]).sum(1)
    c = pos.double() + torch.einsum("bij,bj->bi", R, model.com.double())
    w, vo = V[:, :3], V[:, 3:]
    vc = vo + torch.linalg.cross(w, c - p0)
    m = model.mass.double()
    Iw = R @ model.inertia.double() @ R.transpose(-1, -2)
    ke = 0.5 * (m * (vc * vc).sum(-1)).sum() + 0.5 * torch.einsum(
        "bi,bij,bj->", w, Iw, w)
    pe = g * (m * c[:, 2]).sum()
    lin = (m[:, None] * vc).sum(0)
    ang = (torch.linalg.cross(c, m[:, None] * vc)
           + torch.einsum("bij,bj->bi", Iw, w)).sum(0)
    return float(ke + pe), lin.numpy(), ang.numpy()


def _analytic_pendulum_qdd():
    l, dt = 0.5, 1e-4
    step = _chain_step(chain_model(1, link_len=l, point_mass=True), dt)
    for theta in (0.3, -0.8, 1.2):
        s1 = step(_chain_state([theta], [0.0]), [0.0])
        np.testing.assert_allclose(float(s1.joint_qd[0]) / dt,
                                   -9.81 / l * np.sin(theta), rtol=2e-3)


def _analytic_rod_inertia():
    l, m, I, dt, theta = 0.5, 2.0, 0.04, 1e-4, 0.7
    step = _chain_step(chain_model(1, link_len=l, mass=m, inertia=I), dt)
    s1 = step(_chain_state([theta], [0.0]), [0.0])
    np.testing.assert_allclose(
        float(s1.joint_qd[0]) / dt,
        -m * 9.81 * l * np.sin(theta) / (m * l * l + I), rtol=2e-3)


def _analytic_torque_response():
    l, m, I, dt = 0.5, 2.0, 0.04, 1e-4
    step = _chain_step(chain_model(1, link_len=l, mass=m, inertia=I), dt)
    s1 = step(_chain_state([0.0], [0.0]), [3.0])
    np.testing.assert_allclose(float(s1.joint_qd[0]) / dt,
                               3.0 / (m * l * l + I), rtol=2e-3)


def _analytic_double_pendulum_energy():
    model = chain_model(2, link_len=0.4, mass=1.5)
    step = _chain_step(model, 2e-4)
    s = _chain_state([1.2, 0.5], [0.0, 0.0])
    e0 = _chain_momenta(model, s)[0]
    for _ in range(500):
        s = step(s, [0.0, 0.0])
    e1 = _chain_momenta(model, s)[0]
    assert abs(e1 - e0) / (abs(e0) + 1e-6) < 5e-3, (e0, e1)


def _analytic_free_body_momentum():
    model = chain_model(1, fixed_base=False)
    step = _chain_step(model, 1e-3, gravity=(0.0, 0.0, 0.0))
    s = _chain_state([0.4], [-1.0], base_z=5.0, lin=(0.3, -0.2, 0.1),
                     ang=(2.0, 3.0, -1.0))
    _, p0, l0 = _chain_momenta(model, s, g=0.0)
    for _ in range(300):
        s = step(s, [0.0])
    _, p1, l1 = _chain_momenta(model, s, g=0.0)
    np.testing.assert_allclose(np.concatenate([l1, p1]),
                               np.concatenate([l0, p0]), rtol=2e-2,
                               atol=2e-3)


ANALYTIC_CASES = {
    "pendulum_qdd": _analytic_pendulum_qdd,
    "rod_inertia": _analytic_rod_inertia,
    "torque_response": _analytic_torque_response,
    "double_pendulum_energy": _analytic_double_pendulum_energy,
    "free_body_momentum": _analytic_free_body_momentum,
}


@pytest.mark.parametrize("case", sorted(ANALYTIC_CASES))
def test_engine_analytic(case):
    """The port's per-robot engine (`physics.engine.physics_step`, one env)
    on the chain models of tests/test_dynamics_analytic.py, at its bars:
    point-mass pendulum qdd = -(g/l) sin(theta) and the rod pendulum's
    -m g l sin(theta) / (m l^2 + I) at rtol 2e-3, the torque response
    tau / (m l^2 + I) at rtol 2e-3, an undamped double pendulum's energy
    over 500 steps within 5e-3, and a tumbling free body's momenta over
    300 steps at rtol 2e-2, atol 2e-3."""
    ANALYTIC_CASES[case]()
