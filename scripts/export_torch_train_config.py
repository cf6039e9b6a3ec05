"""Export the composed training config of the shipped policy's PPO run
as JSON, for the PyTorch port.

    python scripts/export_torch_train_config.py [--out-dir DIR]

Composes ``scripts/ramp_job_partitioning_configs/rllib_config.yaml`` with
``env_config=env_load32_price_mixed``, ``algo=ppo`` and
``epoch_loop=epoch_loop_default`` through the JAX package's config loader
(and its reference-compat pass, as ``scripts/train_from_config.py``
does), and writes ``train_config_price_mixed.json`` (default directory:
``ddls_tpu_torch/data``): what ``python -m ddls_tpu_torch.train --config``
reads on a machine without PyYAML. The ``_target_`` paths stay as the
configs name them (``ddls_tpu.*``); the port maps them onto its own
classes. Deterministic: rerunning it rewrites the file byte for byte.
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
OUT_NAME = "train_config_price_mixed.json"
OVERRIDES = ("env_config=env_load32_price_mixed", "algo=ppo",
             "epoch_loop=epoch_loop_default")


def composed_config() -> dict:
    from ddls_tpu.config import load_config
    from ddls_tpu.train.compat import apply_reference_compat

    cfg = load_config(CONFIG_PATH, "rllib_config", list(OVERRIDES))
    return apply_reference_compat(cfg)


def config_text(cfg: dict) -> str:
    return json.dumps(cfg, indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=OUT_DIR)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, OUT_NAME)
    with open(path, "w") as fh:
        fh.write(config_text(composed_config()))
    print(json.dumps({"out": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
