"""The vision pipeline's modules on the card against their CPU results.

Marked `gpu`: each test decides inside itself whether a CUDA device is
present and skips otherwise (the CPU parity with the JAX package is
tests/test_torch_vision.py's). Run on a GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_vision_gpu.py

- the depth camera with the robot's spheres (kernel A gives the sphere
  centres on the card, its plain version on the CPU) at 256 envs on the
  small parkour course: every pixel within 1e-5 but for at most 0.1%, each
  off by one march step or, on a sphere's silhouette, by less than 1e-3;
  one kernel A launch a frame;
- the Q ensemble (10 critics, stacked weights) and one critic step, TF32
  off: Q-values and updated weights within 1e-5 of the CPU's.
"""
import numpy as np
import pytest
import torch

from wtw_tpu_torch.envs import depth
from wtw_tpu_torch.learn import ddpg_demos as D
from wtw_tpu_torch.models import load_robot
from wtw_tpu_torch.physics import kernels as K
from wtw_tpu_torch.terrain import ParkourTerrainCfg, build_parkour, to_heightfield

pytestmark = pytest.mark.gpu


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel A has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_renderer_on_the_card_matches_the_cpu():
    dev = _device()
    tm = build_parkour(ParkourTerrainCfg(num_levels=3, num_terrains=5,
                                         border_size=4.0), seed=0)
    rng = np.random.RandomState(0)
    n = 256
    o = tm.env_origins.reshape(-1, 3)[rng.choice(15, n)]
    pos = (o + np.c_[rng.uniform(0.5, 3.0, n), rng.uniform(-.3, .3, n),
                     0.3 + rng.uniform(0, .1, n)]).astype(np.float32)
    q = np.c_[0.05 * rng.randn(n, 2), np.zeros(n), np.ones(n)]
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    jq = (np.tile([0.1, 0.8, -1.5, -0.1, 0.8, -1.5, 0.1, 1.0, -1.5, -0.1,
                   1.0, -1.5], (n, 1)) + 0.3 * rng.randn(n, 12)).astype(
                       np.float32)
    cfg = depth.DepthCameraCfg(position=(-0.6, 0.0, 0.2))
    frames = {}
    for d in ("cpu", dev):
        render = depth.make_depth_fn(to_heightfield(tm, device=d), cfg,
                                     model=load_robot("go2", device=d))
        K.FK.launches = 0
        frames[str(d)] = render(*[torch.from_numpy(a).to(d)
                                  for a in (pos, q, jq)]).cpu().numpy()
    assert K.FK.launches == 1
    got, want = frames["cuda"], frames["cpu"]
    diff = np.abs(got - want)
    off = diff > 1e-5
    flips = off & (np.abs(diff - 1.0 / 47) <= 1e-5)
    assert off.sum() <= 1e-3 * diff.size
    assert (diff[off & ~flips] < 1e-3).all()


def test_q_ensemble_on_the_card_matches_the_cpu():
    dev = _device()
    args = D.DDPGArgs()
    rng = np.random.RandomState(0)
    B, L = 16, 5
    f = lambda *s: rng.randn(*s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    batch = {"obs": f(B, L, 45), "priv": f(B, L, 189),
             "vobs": u(B, L, 48, 48), "actions": np.tanh(f(B, L, 12)),
             "rewards": f(B, L), "done_prob": 0.3 * u(B, L),
             "true_dones": np.zeros((B, L), np.float32),
             "next_obs": f(B, L, 45), "next_priv": f(B, L, 189),
             "next_vobs": u(B, L, 48, 48), "hidden_in0": f(B, 256),
             "hidden_out0": f(B, 256), "mask": np.ones((B, L), np.float32)}
    noise, sel = f(B, L, 12), torch.tensor([3, 7])
    out = {}
    for d in ("cpu", dev):
        ln = D.DDPGLearner(189, 12, args, seed=0, device=d)
        tb = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        with torch.no_grad():
            q = ln.qs(tb["priv"].reshape(B * L, -1),
                      tb["actions"].reshape(B * L, -1))
        loss = ln.q_update(tb, noise=torch.from_numpy(noise).to(d),
                           sel=sel.to(d))
        out[str(d)] = (q.cpu(), float(loss),
                       {k: v.cpu() for k, v in ln.qs.state_dict().items()})
    (qc, lc, wc), (qg, lg, wg) = out["cpu"], out["cuda"]
    assert qg.shape == (10, B * L)
    torch.testing.assert_close(qg, qc, atol=1e-5, rtol=0)
    assert lg == pytest.approx(lc, rel=1e-4)
    for k in wc:
        torch.testing.assert_close(wg[k], wc[k], atol=1e-5, rtol=0)
