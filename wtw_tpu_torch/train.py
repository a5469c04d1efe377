"""Train a quadruped locomotion policy with the PyTorch/CUDA port (the
counterpart of `scripts/train.py`):

    python -m wtw_tpu_torch.train --preset go1_flat --num-envs 4096 --iterations 100
    python -m wtw_tpu_torch.train --preset b1_mob --iterations 100
    python -m wtw_tpu_torch.train --algo rma --iterations 100
    python -m wtw_tpu_torch.train --pbt 4 --iterations 100

Every preset of `config.PRESETS` trains: go1, go2 and b1 on flat ground or
with the gait-conditioned MoB recipe on the Stack-A map, and the
mini-cheetah on flat ground. `--algo rma` trains the teacher-student RMA
learner (`<run-dir>/rma_state.pt`), `--pbt N` a population of N PPO
learners (`<run-dir>/pbt_state.pt`). Runs on the CUDA device unless
`--device cpu` is given. `--resume` takes the port's own checkpoint of the
same kind (`state_<tag>.pt`, `rma_state.pt`, `pbt_state.pt`), or for the
PPO learner a checkpoint of the JAX runner (`state_<tag>.pkl`, or a slim
`.pkl.gz` of `tools/slim_checkpoint.py`), as `scripts/train.py` does:

    python -m wtw_tpu_torch.train --preset go1_mob --resume checkpoints/go1_mob_r5b_cot.pkl.gz
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from . import config as C
from . import resolve_device


def build(preset: str, num_envs=None, overrides=(), device=None, seed=0,
          run_dir=None, log_freq=10, save_interval=400, control=None,
          actuator_model_wrapper=False, resume=None, algo="ppo_cse", pbt=0,
          pbt_args=None):
    """(env, runner) for a preset; `overrides` are `section.field=value`
    strings routed like scripts/train.py: `ppo.*` to PPOArgs, `runner.*` to
    RunnerArgs, `ac.*` to ACArgs, the rest to the Cfg tree. `control`
    overrides the control type ("P" or "actuator_net"),
    `actuator_model_wrapper` wraps the env in `ActuatorModelWrapper`, and
    `resume` is a checkpoint to continue from (the port's own, or for the
    PPO learner a JAX runner's `.pkl` / `.pkl.gz`). The
    runner is dispatched as scripts/train.py does: `pbt` > 0 gives a
    `learn.pbt.Population` of that many members (`pbt_args`, a PBTArgs,
    sets the rest), else `algo="rma"` an `RMARunner`, else the PPO
    `Runner`; each has `learn(iterations, log_fn)`."""
    from .envs import make_legged_env
    from .learn import PPOArgs, Runner, RunnerArgs
    from .learn.runner import RMARunner
    from .models.actor_critic import ACArgs

    dev = resolve_device(device)
    if dev.type == "cuda":
        # true fp32 everywhere: TF32 is below the engine's precision; and
        # bf16 products (ac.compute_dtype) accumulate in fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = C.PRESETS[preset]()
    if num_envs:
        cfg = dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env, num_envs=num_envs))
    if control:
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, control_type=control))
    pick = lambda pre: [s[len(pre):] for s in overrides if s.startswith(pre)]
    cfg = C.apply_overrides(cfg, [s for s in overrides if not s.startswith(
        ("ppo.", "runner.", "ac."))])
    ppo_args = C.apply_overrides(PPOArgs(), pick("ppo."))
    ac_args = C.apply_overrides(ACArgs(), pick("ac."))
    run_dir = run_dir or f"runs/{preset}/seed{seed}"
    runner_args = C.apply_overrides(
        RunnerArgs(run_dir=run_dir, log_freq=log_freq,
                   save_interval=save_interval, resume=resume is not None,
                   resume_path=resume), pick("runner."))
    env = make_legged_env(cfg, device=dev, seed=seed)
    if actuator_model_wrapper:
        from .envs.wrappers import ActuatorModelWrapper
        env = ActuatorModelWrapper(env)
    if pbt:
        from .learn.pbt import PBTArgs, Population
        pargs = dataclasses.replace(pbt_args or PBTArgs(), population=pbt)
        runner = Population(env, ppo_args, pargs, seed=seed, run_dir=run_dir,
                            log_freq=runner_args.log_freq)
        if resume:
            runner.load(resume)
    elif algo == "rma":
        runner = RMARunner(env, ppo_args, run_dir=run_dir, seed=seed,
                           log_freq=runner_args.log_freq, resume=resume)
    else:
        runner = Runner(env, ppo_args, ac_args=ac_args,
                        runner_args=runner_args, seed=seed)
    return env, runner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="go1_flat",
                    choices=sorted(C.PRESETS))
    ap.add_argument("--num-envs", type=int, default=None)
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint to resume: the port's (state_<tag>.pt, "
                         "rma_state.pt, pbt_state.pt) or a JAX runner's "
                         "(.pkl, .pkl.gz)")
    ap.add_argument("--log-freq", type=int, default=10)
    ap.add_argument("--save-interval", type=int, default=400)
    ap.add_argument("--control", default=None, choices=["P", "actuator_net"],
                    help="override the control type")
    ap.add_argument("--actuator-model-wrapper", action="store_true",
                    help="wrap the env with the Go2 actuator model "
                         "(delay, friction, low-pass filter)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="config override, e.g. --set ppo.learning_rate=5e-4")
    ap.add_argument("--algo", default="ppo_cse", choices=["ppo_cse", "rma"],
                    help="rma = the reference's go1_gym_learn/ppo/ "
                         "teacher-student RMA variant (env-factor encoder)")
    ap.add_argument("--pbt", type=int, default=0, metavar="N",
                    help="population-based training with N members")
    args = ap.parse_args(argv)
    env, runner = build(args.preset, args.num_envs, args.set, args.device,
                        args.seed, args.run_dir, args.log_freq,
                        args.save_interval, control=args.control,
                        actuator_model_wrapper=args.actuator_model_wrapper,
                        resume=args.resume, algo=args.algo, pbt=args.pbt)
    run_dir = args.run_dir or f"runs/{args.preset}/seed{args.seed}"
    print(f"preset={args.preset} robot={env.cfg.asset.robot} "
          f"envs={env.num_envs} obs={env.num_obs} algo={args.algo}"
          f"{f' pbt={args.pbt}' if args.pbt else ''} device={env.device} "
          f"-> {run_dir}")
    runner.learn(args.iterations)


if __name__ == "__main__":
    main()
