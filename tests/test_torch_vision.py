"""Parity of the port's vision-distillation modules (wtw_tpu_torch.envs
.depth, .learn.ddpg_demos and their converters, on the CPU) with the JAX
package's `wtw_tpu/envs/depth.py` and `wtw_tpu/learn/ddpg_demos.py`.

- The depth camera on the small parkour course (3 levels x 5 track types)
  and in front of a wall, with and without the robot's spheres, at 4 envs
  from seeded poses: every pixel within 1e-5 of JAX's but for at most 0.1%
  of them, each off by exactly one march step or, on a sphere's silhouette,
  by less than 1e-3 (today: no march-step pixel, and one silhouette pixel
  off by 1.2e-5 in the 36,864 of the wall's frames).
- The vision net, one actor step and the Q ensemble at full width against
  `vision_apply`, `actor_apply` and `q_apply` at 1e-5, on JAX's weights
  carried by `vision_params_from_jax` / `ddpg_state_from_jax`.
- The ring buffer: `buffer_add` and `buffer_sample` bit-equal to JAX's on
  the same draws, before and after the ring wraps (windows that would cross
  the write seam start from the oldest entry instead).
- One `q_update`, `target_update`, `actor_update` and `bc_update` (full
  widths, 3 critics), each from the same state, against JAX's with the
  JAX draws patched to numpy draws that the port is also given (the JAX
  updates jitted, the draws served while they trace): weights at 1e-5
  absolute, losses at 1e-4 relative (the bars of
  tests/test_torch_cat_learners.py); an element whose gradient is at the
  scale of Adam's eps (a first moment under 1e-7) within one learning
  rate, at most 3 of them off by more than 1e-5 (1 measured).
- `generate_demos` (3 steps) and `train_vision_student` (2 env steps after
  2 BC batches, with a warm-up step and an actor hold) at 8 envs on a
  scripted env whose poses, observations, rewards and dones come from
  numpy tables and move with the actions, every draw served from numpy to
  both sides.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wtw_tpu.envs import depth as jdepth
from wtw_tpu.learn import ddpg_demos as JD
from wtw_tpu.models import load_robot as jax_load_robot
from wtw_tpu.physics.heightfield import make_heightfield as jax_make_hf
from wtw_tpu.terrain import ParkourTerrainCfg as JaxTerrainCfg
from wtw_tpu.terrain import build_parkour as jax_build_parkour
from wtw_tpu.terrain import to_heightfield as jax_to_hf

from wtw_tpu_torch.convert import (ddpg_state_from_jax, q_ensemble_from_jax,
                                   vision_params_from_jax)
from wtw_tpu_torch.envs import depth as tdepth
from wtw_tpu_torch.learn import ddpg_demos as TD
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.physics.heightfield import make_heightfield
from wtw_tpu_torch.terrain import ParkourTerrainCfg, build_parkour, to_heightfield

np_tree = lambda tree: jax.tree.map(np.asarray, tree)
GO2_Q = [0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1, 1.0, -1.5]


# ---------------------------------------------------------------------------
# the depth camera
# ---------------------------------------------------------------------------


def _poses(rng, origins, n=4):
    """Seeded poses a little past the given origins, facing +x."""
    o = origins[rng.choice(len(origins), n)]
    pos = o + np.c_[rng.uniform(0.5, 3.0, n), rng.uniform(-0.3, 0.3, n),
                    0.3 + rng.uniform(0.0, 0.1, n)]
    yaw = rng.uniform(-0.3, 0.3, n)
    q = np.c_[0.05 * rng.randn(n), 0.05 * rng.randn(n), np.sin(yaw / 2),
              np.cos(yaw / 2)]
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    jq = np.tile(GO2_Q, (n, 1)) + 0.3 * rng.randn(n, 12)
    return [a.astype(np.float32) for a in (pos, q, jq)]


def _course():
    kw = dict(num_levels=3, num_terrains=5, border_size=4.0)
    tm, jtm = build_parkour(ParkourTerrainCfg(**kw), seed=0), \
        jax_build_parkour(JaxTerrainCfg(**kw), seed=0)
    return (to_heightfield(tm), jax_to_hf(jtm),
            tm.env_origins.reshape(-1, 3))


def _wall():
    h = np.zeros((80, 80), np.float32)
    h[41:, :] = 0.5          # a 0.5 m step ~0.5 m ahead of the origin
    return (make_heightfield(h, 0.5, [-20.0, -20.0]),
            jax_make_hf(jnp.asarray(h), 0.5, jnp.asarray([-20.0, -20.0])),
            np.array([[-2.0, 0.0, 0.0]]))


def _compare_frames(got, want, cfg, sphere_pixels=None):
    """Every pixel within 1e-5, but for at most 0.1% of them, each off by
    exactly one march step (a sample within rounding of the ground) or, on
    a sphere's silhouette, by less than 1e-3 (a grazing ray's near root,
    b - sqrt(disc) with disc near 0, amplifies the ~1e-7 m difference of
    the two packages' sphere centres). -> (march-step pixels, silhouette
    pixels)."""
    d = np.abs(got - want)
    step = 1.0 / (cfg.march_steps - 1)
    off = d > 1e-5
    flips = off & (np.abs(d - step) <= 1e-5)
    graze = off & ~flips
    assert off.sum() <= 1e-3 * d.size, off.sum()
    if graze.any():
        assert sphere_pixels is not None and sphere_pixels[graze].all()
        assert d[graze].max() < 1e-3, d[graze].max()
    return int(flips.sum()), int(graze.sum())


@pytest.mark.parametrize("scene", ["course", "wall"])
def test_depth_matches_jax(scene):
    hf, jhf, origins = _course() if scene == "course" else _wall()
    rng = np.random.RandomState(0)
    pos, quat, jq = _poses(rng, origins)
    model, jmodel = load_robot("go2"), jax_load_robot("go2")
    # the default camera, and one behind the base so the body is in view
    cams = [(tdepth.DepthCameraCfg(), jdepth.DepthCameraCfg()),
            (tdepth.DepthCameraCfg(position=(-0.6, 0.0, 0.2)),
             jdepth.DepthCameraCfg(position=(-0.6, 0.0, 0.2)))]
    t = lambda *a: [torch.from_numpy(x) for x in a]
    counts = {}
    for cfg, jcfg in cams:
        plain = tdepth.make_depth_fn(hf, cfg)(*t(pos, quat)).numpy()
        want = np.asarray(jdepth.make_depth_fn(jhf, jcfg)(pos, quat))
        assert plain.shape == (4, 48, 48)
        counts[cfg.position] = [_compare_frames(plain, want, cfg)]
        legs = tdepth.make_depth_fn(hf, cfg, model=model)(
            *t(pos, quat, jq)).numpy()
        want_legs = np.asarray(jdepth.make_depth_fn(jhf, jcfg, model=jmodel)(
            pos, quat, jq))
        counts[cfg.position].append(_compare_frames(
            legs, want_legs, cfg, sphere_pixels=legs < plain))
        assert (legs <= plain + 1e-6).all()
    # the camera behind the base sees the body; the terrain fills the frame
    assert int((legs < plain - 0.2).sum()) > 20
    assert 0.0 < float((plain < 1.0).mean()) < 1.0
    # measured (CPU, numpy seed 0): no march-step pixel and no silhouette
    # pixel on the course; on the wall one silhouette pixel (1.2e-5) of the
    # 9216 with the camera behind the base
    assert counts == MEASURED[scene]


MEASURED = {"course": {(0.3, 0.0, 0.1): [(0, 0), (0, 0)],
                       (-0.6, 0.0, 0.2): [(0, 0), (0, 0)]},
            "wall": {(0.3, 0.0, 0.1): [(0, 0), (0, 0)],
                     (-0.6, 0.0, 0.2): [(0, 0), (0, 1)]}}


def test_kernel_a_is_the_renderer_sphere_source():
    """The sphere centres of the self-view come from kernel A's fk_p rows
    (its plain version on the CPU) and equal the JAX renderer's."""
    from wtw_tpu.physics.engine import fk as jax_fk
    from wtw_tpu.utils.quat import quat_to_matrix
    rng = np.random.RandomState(1)
    pos, quat, jq = _poses(rng, np.zeros((1, 3)))
    model, jmodel = load_robot("go2"), jax_load_robot("go2")
    got = tdepth.sphere_centres(model, *map(torch.from_numpy,
                                            (pos, quat, jq))).numpy()
    for i in range(4):
        bp, bq, _, _ = jax_fk(jmodel, pos[i], quat[i], jq[i])
        R = quat_to_matrix(bq)
        want = bp[jmodel.sph_body] + jnp.einsum(
            "kij,kj->ki", R[jmodel.sph_body], jmodel.sph_pos)
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

PRIV, ACT = 189, 12


def _jax_state(args, key=0, priv=PRIV, act=ACT):
    """JAX's initial train state (jitted: eagerly its inits take ~13 s)."""
    actor_tx, q_tx, *_ = JD.make_update_fns(args)
    init = jax.jit(JD.init_train_state, static_argnums=(1, 2, 3, 4, 5))
    if not isinstance(key, jax.Array):
        key = jax.random.PRNGKey(key)
    return init(key, priv, act, args, actor_tx, q_tx)


def _port_learner(ts, args, priv=PRIV, act=ACT):
    ln = TD.DDPGLearner(priv, act, args)
    ln.load_state(ddpg_state_from_jax(np_tree(ts), ln))
    return ln


def test_networks_match_jax():
    args = JD.DDPGArgs()
    ts = _jax_state(args)
    ln = _port_learner(ts, TD.DDPGArgs())
    rng = np.random.RandomState(0)
    n = 6
    img = rng.uniform(0, 1, (n, 48, 48)).astype(np.float32)
    proprio = rng.randn(n, 45).astype(np.float32)
    h = (0.5 * rng.randn(n, 256)).astype(np.float32)
    priv = rng.randn(n, PRIV).astype(np.float32)
    act = rng.uniform(-1, 1, (n, ACT)).astype(np.float32)
    with torch.no_grad():
        vl = ln.vision(torch.from_numpy(img))
        a, h2 = ln.actor(torch.from_numpy(proprio), vl, torch.from_numpy(h))
        q = ln.qs(torch.from_numpy(priv), torch.from_numpy(act))
    jvl = JD.vision_apply(ts.vision, img)
    ja, jh2 = JD.actor_apply(ts.actor, proprio, jvl, h, args)
    jq = jax.vmap(lambda p: JD.q_apply(p, priv, act))(ts.qs)
    for g, w, name in ((vl, jvl, "vision"), (a, ja, "actions"),
                       (h2, jh2, "hidden"), (q, jq, "q")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   err_msg=name)
    assert q.shape == (10, n)
    # the committed student's layout carries across
    blob = vision_params_from_jax({"actor": np_tree(ts.actor),
                                   "vision": np_tree(ts.vision)})
    assert blob["actor.memory.weight_ih"].shape == (768, 173)
    assert blob["vision.l1.weight"].shape == (128, 1568)
    assert q_ensemble_from_jax(np_tree(ts.qs))["w0"].shape == (10, 201, 512)


# ---------------------------------------------------------------------------
# the ring buffer
# ---------------------------------------------------------------------------


class _Feed:
    """Numpy draws served in call order, one RandomState per kind, so two
    consumers built from the same seed see the same values."""

    def __init__(self, seed):
        self.rng = {k: np.random.RandomState(seed + i) for i, k in enumerate(
            ("randint", "normal", "permutation", "uniform"))}

    # the port's Draws interface
    def randint(self, high, n):
        return torch.from_numpy(self.rng["randint"].randint(0, int(high), n))

    def normal(self, shape):
        return torch.from_numpy(self.rng["normal"].randn(*shape).astype(
            np.float32))

    def permutation(self, n):
        return torch.from_numpy(self.rng["permutation"].permutation(n))

    def uniform(self, shape, low, high):
        return torch.from_numpy(self.rng["uniform"].uniform(
            low, high, shape).astype(np.float32))

    def patch_jax(self, monkeypatch):
        r = self.rng
        monkeypatch.setattr(jax.random, "randint", lambda k, shape, lo, hi: (
            jnp.asarray(r["randint"].randint(int(lo), int(hi), shape))))
        monkeypatch.setattr(jax.random, "normal", lambda k, shape: (
            jnp.asarray(r["normal"].randn(*shape).astype(np.float32))))
        monkeypatch.setattr(jax.random, "permutation", lambda k, n: (
            jnp.asarray(r["permutation"].permutation(int(n)))))
        monkeypatch.setattr(
            jax.random, "uniform", lambda k, shape, minval, maxval: (
                jnp.asarray(r["uniform"].uniform(
                    minval, maxval, shape).astype(np.float32))))


def _step_data(rng, n, priv, act, hid):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return (f(n, 45), f(n, priv), rng.randint(0, 256, (n, 48, 48)).astype(
        np.uint8), f(n, act), f(n), rng.uniform(0, 1, n).astype(np.float32),
            (rng.uniform(0, 1, n) < 0.2).astype(np.float32), f(n, hid))


def _same_buffer(buf, jbuf):
    for f in TD.SeqBuffer.TENSORS:
        got, want = getattr(buf, f), np.asarray(getattr(jbuf, f))
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert (buf.pos, buf.filled) == (int(jbuf.pos), int(jbuf.filled))


def test_buffer_matches_jax_bits_across_the_seam(monkeypatch):
    args = TD.DDPGArgs(buffer_steps=8, seq_len=3)
    jargs = JD.DDPGArgs(buffer_steps=8, seq_len=3)
    n, priv, act, hid = 5, 7, 3, 256
    buf = TD.init_buffer(args, n, priv, act)
    jbuf = JD.init_buffer(jargs, n, priv, act)
    rng = np.random.RandomState(0)
    feed_t, feed_j = _Feed(3), _Feed(3)
    feed_j.patch_jax(monkeypatch)
    for t in range(13):           # wraps at 8: the seam sits at pos 5
        data = _step_data(rng, n, priv, act, hid)
        TD.buffer_add(buf, *map(torch.from_numpy, data))
        jbuf = JD.buffer_add(jbuf, *map(jnp.asarray, data))
        _same_buffer(buf, jbuf)
        if t in (2, 6, 12):
            got = TD.buffer_sample(buf, feed_t, 16, args.seq_len)
            want = JD.buffer_sample(jbuf, jax.random.PRNGKey(0), 16,
                                    args.seq_len)
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), err_msg=k)
    # after the wrap no window reads across the seam: each starts at or
    # after the oldest entry and ends before the newest
    assert buf.filled == 8 and buf.pos == 5
    assert set(np.unique(got["mask"].numpy())) <= {0.0, 1.0}
    # the f32 demo files of older JAX runs cast to the storage dtypes
    f32 = TD.SeqBuffer(**{f: getattr(buf, f).float()
                          if getattr(buf, f).dtype == torch.bfloat16
                          else getattr(buf, f) for f in TD.SeqBuffer.TENSORS})
    back = TD.buffer_astype(f32)
    assert back.obs.dtype == torch.bfloat16
    assert torch.equal(back.obs, buf.obs)


# ---------------------------------------------------------------------------
# the four updates
# ---------------------------------------------------------------------------


def _batch(rng, B=8, L=5, priv=PRIV, act=ACT):
    f = lambda *s: rng.randn(*s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[1, 3:] = 0.0
    mask[4, 1:] = 0.0
    return {"obs": f(B, L, 45), "priv": f(B, L, priv), "vobs": u(B, L, 48, 48),
            "actions": np.clip(f(B, L, act), -1.5, 1.5),
            "rewards": f(B, L), "done_prob": 0.3 * u(B, L),
            "true_dones": (u(B, L) < 0.1).astype(np.float32),
            "next_obs": f(B, L, 45), "next_priv": f(B, L, priv),
            "next_vobs": u(B, L, 48, 48), "hidden_in0": 0.5 * f(B, 256),
            "hidden_out0": 0.5 * f(B, 256), "mask": mask}


def _check_learner(ln, ts, parts=("student", "qs", "q_targets")):
    """Weights at 1e-5 absolute; an element whose Adam first moment is below
    1e-7 (a gradient at the scale of Adam's eps, 1e-8, where the step
    g / (|g| + eps) turns ulp-level gradient differences into ~1e-5 moves)
    within one learning rate. -> the count of such elements off by more than
    1e-5."""
    want = ddpg_state_from_jax(np_tree(ts), ln)
    got = ln.state()
    small = {}
    for opt, module, part in (("actor_opt", ln.student, "student"),
                              ("q_opt", ln.qs, "qs")):
        ids = want[opt]["param_groups"][0]["params"]
        for i, (n, _) in zip(ids, module.named_parameters()):
            if i in want[opt]["state"]:
                small[f"{part}.{n}"] = (
                    want[opt]["state"][i]["exp_avg"].abs() < 1e-7).numpy()
    n_small = 0
    for part in parts:
        for k, v in want[part].items():
            g, w = got[part][k].numpy(), v.numpy()
            near = small.get(f"{part}.{k}", np.zeros(w.shape, bool))
            np.testing.assert_allclose(g[~near], w[~near], atol=1e-5,
                                       err_msg=f"{part}.{k}")
            assert (np.abs(g - w)[near] <= 3e-4).all(), f"{part}.{k}"
            n_small += int((np.abs(g - w)[near] > 1e-5).sum())
    return n_small


def test_updates_match_jax(monkeypatch):
    # full widths but 3 critics (the 10-critic forward is
    # test_networks_match_jax's): the un-jitted JAX side dominates
    args, targs = JD.DDPGArgs(critic_nb=3), TD.DDPGArgs(critic_nb=3)
    # each JAX update is jitted once (eagerly its scan recompiles every
    # call); the patched draws are served while it traces
    q_update, target_update, actor_update, bc_update = map(
        jax.jit, JD.make_update_fns(args)[2:])
    ts = _jax_state(args, key=3)
    ln = _port_learner(ts, targs)
    batch = _batch(np.random.RandomState(5))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = np.random.RandomState(9)
    noise = rng.randn(8, 5, ACT).astype(np.float32)
    perm = rng.permutation(3)
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape: jnp.asarray(noise))
    monkeypatch.setattr(jax.random, "permutation",
                        lambda k, n: jnp.asarray(perm))

    ts, jq = q_update(ts, jb)
    q = ln.q_update(tb, noise=torch.from_numpy(noise),
                    sel=torch.from_numpy(perm[:2]))
    assert float(q) == pytest.approx(float(jq), rel=1e-4)
    _check_learner(ln, ts, ("qs",))

    ts = target_update(ts)
    ln.target_update()
    _check_learner(ln, ts, ("q_targets",))

    # each update from the same state: the port is re-seated on JAX's
    ln.load_state(ddpg_state_from_jax(np_tree(ts), ln))
    ts, ja = actor_update(ts, jb)
    a = ln.actor_update(tb)
    assert float(a) == pytest.approx(float(ja), rel=1e-4)
    assert ln.step == int(ts.step) == 1
    eps_regime = _check_learner(ln, ts, ("student",))

    ln.load_state(ddpg_state_from_jax(np_tree(ts), ln))
    ts, jbc = bc_update(ts, jb)
    bc = ln.bc_update(tb)
    assert float(bc) == pytest.approx(float(jbc), rel=1e-4)
    eps_regime += _check_learner(ln, ts)
    # both Adam states: the step counts and the first moments
    want = ddpg_state_from_jax(np_tree(ts), ln)
    for opt in ("actor_opt", "q_opt"):
        for i, s in want[opt]["state"].items():
            g = ln.state()[opt]["state"][i]
            assert float(g["step"]) == float(s["step"])
            np.testing.assert_allclose(g["exp_avg"].numpy(),
                                       s["exp_avg"].numpy(), atol=1e-6)
    # measured (CPU, the JAX updates jitted): one element in Adam's eps
    # regime is off by more than 1e-5 (and within one learning rate)
    assert eps_regime <= 3


# ---------------------------------------------------------------------------
# the two stages on a scripted env
# ---------------------------------------------------------------------------

NS, OS, T_MAX = 8, 50, 8


class _Script:
    """Numpy tables: poses over a bumpy field, obs[t] + tanh(a) @ M, rewards
    moved by the actions, soft dones and one hard done (env 3, step 1)."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        f = lambda *s: rng.randn(*s).astype(np.float32)
        self.heights = (0.05 * f(40, 40)).astype(np.float32)
        self.heights[25:, :] += 0.3
        self.pos = np.stack([np.c_[0.2 * t + rng.uniform(-.1, .1, NS),
                                   rng.uniform(-.5, .5, NS),
                                   0.32 + 0.02 * rng.randn(NS)]
                             for t in range(T_MAX + 1)]).astype(np.float32)
        q = np.c_[0.03 * rng.randn((T_MAX + 1) * NS, 3),
                  np.ones((T_MAX + 1) * NS)]
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        self.quat = q.reshape(T_MAX + 1, NS, 4).astype(np.float32)
        self.jq = (np.tile(GO2_Q, (T_MAX + 1, NS, 1))
                   + 0.2 * rng.randn(T_MAX + 1, NS, 12)).astype(np.float32)
        self.obs0, self.obs = f(NS, OS), f(T_MAX, NS, OS)
        self.m = 0.1 * f(ACT, OS)
        self.rew = f(T_MAX, NS)
        self.done = rng.uniform(0, 0.3, (T_MAX, NS)).astype(np.float32)
        self.hard = np.zeros((T_MAX, NS), bool)
        self.hard[1, 3] = True
        self.w_expert = 0.3 * f(OS, ACT)


def _world(s, t, mk):
    phys = types.SimpleNamespace(base_pos=mk(s.pos[t]),
                                 base_quat=mk(s.quat[t]), joint_q=mk(s.jq[t]))
    return types.SimpleNamespace(t=t, env=types.SimpleNamespace(phys=phys))


class _JaxStub:
    num_envs, num_obs, num_actions = NS, OS, ACT

    def __init__(self, s):
        self.s, self.model = s, jax_load_robot("go2")
        self.hf = jax_make_hf(jnp.asarray(s.heights), 0.1,
                              jnp.asarray([-1.0, -2.0]))

    def init_state(self, key):
        return _world(self.s, 0, jnp.asarray)

    def get_observations(self, world):
        return jnp.asarray(self.s.obs0)

    def step(self, world, a):
        s, t = self.s, world.t
        obs = jnp.asarray(s.obs[t]) + jnp.tanh(a) @ jnp.asarray(s.m)
        rew = jnp.asarray(s.rew[t]) - 0.01 * jnp.sum(a * a, -1)
        return (_world(s, t + 1, jnp.asarray), obs, rew,
                jnp.asarray(s.done[t]), {"true_dones": jnp.asarray(s.hard[t])})


class _TorchStub:
    num_envs, num_obs, num_actions = NS, OS, ACT
    device = torch.device("cpu")

    def __init__(self, s):
        self.s, self.model = s, load_robot("go2")
        self.hf = make_heightfield(s.heights, 0.1, [-1.0, -2.0])

    def init_state(self, seed):
        return _world(self.s, 0, torch.from_numpy)

    def get_observations(self, world):
        return torch.from_numpy(self.s.obs0)

    def step(self, world, a):
        s, t = self.s, world.t
        obs = torch.from_numpy(s.obs[t]) + torch.tanh(a) @ torch.from_numpy(
            s.m)
        rew = torch.from_numpy(s.rew[t]) - 0.01 * (a * a).sum(-1)
        return (_world(s, t + 1, torch.from_numpy), obs, rew,
                torch.from_numpy(s.done[t]),
                {"true_dones": torch.from_numpy(s.hard[t])})


def _close_buffer(buf, jbuf):
    """Stored fields of two rollouts whose actions agree to ~1e-6: the
    float fields at 1e-5 (bf16 ones within one bf16 step), the depth frames
    equal but for at most 0.1% of pixels."""
    for f in TD.SeqBuffer.TENSORS:
        got = getattr(buf, f).float().numpy()
        want = np.asarray(getattr(jbuf, f)).astype(np.float32)
        if f == "vobs":
            assert (got != want).mean() <= 1e-3, f
            continue
        tol = 1e-5 + (8e-3 * np.abs(want) if getattr(buf, f).dtype
                      == torch.bfloat16 else 0.0)
        assert (np.abs(got - want) <= tol).all(), f
    assert (buf.pos, buf.filled) == (int(jbuf.pos), int(jbuf.filled))


SMALL_ARGS = dict(buffer_steps=8, batch_size=4, seq_len=3, critic_nb=3,
                  updates_per_step=1, learning_starts=4,
                  vision_update_interval=2, actor_delay_env_steps=NS)


def test_generate_demos_matches_jax():
    s = _Script()
    args, jargs = TD.DDPGArgs(**SMALL_ARGS), JD.DDPGArgs(**SMALL_ARGS)
    w = s.w_expert
    with jax.disable_jit():
        jbuf = JD.generate_demos(lambda o: jnp.tanh(o @ jnp.asarray(w)),
                                 _JaxStub(s), 3, jax.random.PRNGKey(0), jargs)
    buf = TD.generate_demos(lambda o: torch.tanh(o @ torch.from_numpy(w)),
                            _TorchStub(s), 3, 0, args)
    _close_buffer(buf, jbuf)
    assert buf.filled == 3 and float(buf.vobs[:3].float().std()) > 0
    assert float(buf.true_dones[1, 3]) == 1.0


def test_train_vision_student_matches_jax(monkeypatch):
    """2 BC batches, then 2 env steps at 8 envs: step 0 takes warm-up
    actions and updates the critics only (the actor is held for 8 env
    steps), step 1 the policy's actions and the actor update too."""
    s = _Script()
    args, jargs = TD.DDPGArgs(**SMALL_ARGS), JD.DDPGArgs(**SMALL_ARGS)
    demos_np = [_step_data(np.random.RandomState(t), NS, OS, ACT, 256)
                for t in range(6)]
    jdemos = JD.init_buffer(jargs, NS, OS, ACT)
    demos = TD.init_buffer(args, NS, OS, ACT)
    for d in demos_np:
        jdemos = JD.buffer_add(jdemos, *map(jnp.asarray, d))
        TD.buffer_add(demos, *map(torch.from_numpy, d))
    key = jax.random.PRNGKey(0)
    ts0 = _jax_state(jargs, jax.random.split(key, 3)[0], OS, ACT)
    ln = TD.DDPGLearner(OS, ACT, args)
    ln.load_state(ddpg_state_from_jax(np_tree(ts0), ln))
    feed_j, ln.draws = _Feed(11), _Feed(11)
    monkeypatch.setattr(JD, "init_train_state", lambda *a, **k: ts0)
    feed_j.patch_jax(monkeypatch)
    logs = []
    with jax.disable_jit():
        ts, jrb = JD.train_vision_student(
            _JaxStub(s), jdemos, 2 * NS, key, jargs, log_fn=logs.append,
            log_freq=1, bc_batches=2)
    monkeypatch.undo()
    tlogs = []
    ln, rb = TD.train_vision_student(
        _TorchStub(s), demos, 2 * NS, 0, args, log_fn=tlogs.append,
        log_freq=1, bc_batches=2, learner=ln)
    ln.draws = TD.Draws("cpu")
    _close_buffer(rb, jrb)
    _check_learner(ln, ts)
    assert ln.step == int(ts.step) == 1
    assert len(tlogs) == len(logs) == 3
    for a, b in zip(tlogs, logs):
        got = [float(x.split()[-1]) for x in a.split("|")[1:]]
        want = [float(x.split()[-1]) for x in b.split("|")[1:]]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
