"""Export the composed training config of a run on the shipped policy's
environment as JSON, for the PyTorch port.

    python scripts/export_torch_train_config.py
        [--algo ppo|impala|pg|apex_dqn|es] [--out-dir DIR]

Composes ``scripts/ramp_job_partitioning_configs/rllib_config.yaml`` with
``env_config=env_load32_price_mixed``, ``algo=<algo>`` and
``epoch_loop=epoch_loop_default`` through the JAX package's config loader
(and its reference-compat pass, as ``scripts/train_from_config.py``
does), and writes it (default directory: ``ddls_tpu_torch/data``): what
``python -m ddls_tpu_torch.train --config`` reads on a machine without
PyYAML.

* ``ppo`` (default): ``train_config_price_mixed.json``, the shipped
  policy's PPO run at epoch_loop_default's 8 envs x 32 steps;
* ``impala``, ``pg``, ``apex_dqn`` and ``es``:
  ``train_config_<algo>_price_mixed.json``, with ``epoch_loop.num_envs``
  and ``rollout_length`` unset, so that each algo yaml's own sizes apply
  (``num_workers`` envs, ``train_batch_size // num_workers`` steps:
  IMPALA 32 x 15, PG 8 x 25, Ape-X DQN 32 x 16, ES a population of 10 x
  200).

The ``_target_`` paths stay as the configs name them (``ddls_tpu.*``);
the port maps them onto its own classes. Deterministic: rerunning it
rewrites a file byte for byte.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
OUT_DIR = os.path.join(REPO, "ddls_tpu_torch", "data")
ALGOS = ("ppo", "impala", "pg", "apex_dqn", "es")
OUT_NAMES = {"ppo": "train_config_price_mixed.json",
             **{algo: f"train_config_{algo}_price_mixed.json"
                for algo in ALGOS[1:]}}
OUT_NAME = OUT_NAMES["ppo"]


def overrides(algo: str = "ppo") -> list:
    out = ["env_config=env_load32_price_mixed", f"algo={algo}",
           "epoch_loop=epoch_loop_default"]
    if algo != "ppo":
        out += ["epoch_loop.num_envs=null", "epoch_loop.rollout_length=null"]
    return out


def composed_config(algo: str = "ppo") -> dict:
    from ddls_tpu.config import load_config
    from ddls_tpu.train.compat import apply_reference_compat

    cfg = load_config(CONFIG_PATH, "rllib_config", overrides(algo))
    return apply_reference_compat(cfg)


def config_text(cfg: dict) -> str:
    return json.dumps(cfg, indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=ALGOS, default="ppo")
    parser.add_argument("--out-dir", default=OUT_DIR)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, OUT_NAMES[args.algo])
    with open(path, "w") as fh:
        fh.write(config_text(composed_config(args.algo)))
    print(json.dumps({"out": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
