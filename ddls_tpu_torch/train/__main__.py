"""Train the partitioning policy with the port's epoch loop (PPO, Ape-X
DQN, IMPALA, PG or ES, as the config's ``algo.algo_name`` says).

    python -m ddls_tpu_torch.train --config CONFIG.json --epochs N
        [--device cuda|cpu] [--init-export EXPORT.npz]
        [--checkpoint-dir DIR] [--eval-episodes K --eval-seed S]

``CONFIG.json`` is a composed config tree (``epoch_loop``,
``env_config``, ``model``, ``algo``, ``eval_config``, ``experiment``), as
``scripts/export_torch_train_config.py`` writes it: under
``ddls_tpu_torch/data/``, ``train_config_price_mixed.json`` (the shipped
policy's PPO run on ``env_load32_price_mixed``, 8 envs x 32 steps),
``train_config_impala_price_mixed.json`` (IMPALA, 32 envs x 15 steps),
``train_config_pg_price_mixed.json`` (PG, 8 envs x 25 steps),
``train_config_apex_dqn_price_mixed.json`` (Ape-X DQN, 32 envs x 16
steps, updates of 512 once 10,000 steps were sampled; its Q-network's
heads are 256 wide, so it starts from flax's initialisation) and
``train_config_es_price_mixed.json`` (ES, a population of 10 at 200 steps
per member); its ``experiment.train_seed`` seeds the loop. The loop runs
as the config's ``epoch_loop`` asks (every exported config: ``loop_mode:
pipelined`` over subprocess envs, ``use_parallel_envs: auto``) and
evaluates every ``eval_config.evaluation_interval`` epochs; it runs on the
card unless ``--device cpu`` is given, and raises when CUDA is asked for
and absent. ``--init-export`` starts from an exported policy of the same
architecture (default: flax's initialisation from the seed). Prints one
JSON line per epoch (``loop_mode`` names the mode it ran); after the last
epoch, ``--eval-episodes`` greedy episodes from ``--eval-seed`` and a
checkpoint under ``--checkpoint-dir`` (one JSON line for both). The
launcher's stop conditions and checkpoint and log cadences are not read.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Optional

from ddls_tpu_torch.train.checkpointer import Checkpointer
from ddls_tpu_torch.train.loops import (RLEpochLoop, build_epoch_loop_kwargs,
                                        make_epoch_loop)
from ddls_tpu_torch.train.metrics import materialize_results


def build_loop(cfg: Dict[str, Any], device: str = "cuda",
               init_export: Optional[str] = None) -> RLEpochLoop:
    """The epoch loop of a composed config, for its algorithm."""
    kwargs = build_epoch_loop_kwargs(cfg)
    kwargs.update(device=device)
    if init_export:
        from ddls_tpu_torch.serve.server import load_export

        kwargs["init_params"] = load_export(init_export)[1]
    algo = (cfg.get("algo") or {}).get("algo_name", "ppo")
    return make_epoch_loop(algo, **kwargs)


def epoch_line(results: Dict[str, Any], loop_mode: str) -> Dict[str, Any]:
    """An epoch's results without the per-episode records, its metrics
    read back, with the loop mode that ran it."""
    line = {k: v for k, v in results.items() if k != "episodes"}
    return {**materialize_results(line), "loop_mode": loop_mode}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--init-export", default=None)
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--eval-episodes", type=int, default=0)
    parser.add_argument("--eval-seed", type=int, default=None)
    args = parser.parse_args(argv)

    with open(args.config) as fh:
        cfg = json.load(fh)
    loop = build_loop(cfg, args.device, args.init_export)
    try:
        for _ in range(args.epochs):
            print(json.dumps(epoch_line(loop.run(), loop.loop_mode)),
                  flush=True)
        final: Dict[str, Any] = {"epochs": loop.epoch_counter,
                                 "total_env_steps": loop.total_env_steps}
        if args.eval_episodes > 0:
            final["evaluation"] = loop.evaluate(args.eval_episodes,
                                                seed=args.eval_seed)
        if args.checkpoint_dir:
            final["checkpoint"] = Checkpointer(args.checkpoint_dir).write(
                loop, loop.epoch_counter)
        print(json.dumps(final), flush=True)
    finally:
        loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
