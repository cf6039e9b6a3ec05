"""Synthetic PipeDream-format workload generation.

The reference's experiments load PipeDream profile graphs from disk
(``env_dev.yaml jobs_config.path_to_files``) but the dataset itself is not part
of the repo. This module synthesises families of DNN training-job profiles --
CNN-like chains with skip connections and translation-like encoder/decoder
chains -- and writes them in the exact PipeDream ``.txt`` profile format the
reader consumes, so the whole file-driven pipeline (reader -> mirror ->
Job -> generator) is exercised end to end.

Scales are chosen so the PAC-ML trade-off is non-trivial under the reference's
canonical config (interarrival 1000, 50 training steps, U(0.1, 1) max-JCT
fraction): sequential JCTs land in the hundreds-to-thousands range, and
deep partitioning buys compute speedup at the price of collective-sync
overhead through the RAMP all-reduce cost model.

Port: a copy of ``ddls_tpu/graphs/synthetic.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

import os
import pathlib
from typing import List, Optional

import numpy as np


def _emit_node(lines: List[str], node_id: int, op_type: str, fwd: float,
               bwd: float, activation: float, parameter: float) -> None:
    lines.append(
        f"node{node_id} -- {op_type}(id={node_id}) -- "
        f"forward_compute_time={fwd:.6f}, backward_compute_time={bwd:.6f}, "
        f"activation_size={activation:.1f}, parameter_size={parameter:.1f}"
    )


def _emit_edge(lines: List[str], u: int, v: int) -> None:
    lines.append(f"node{u} -- node{v}")


def make_cnn_profile(rng: np.random.Generator,
                     n_ops: int,
                     compute_scale: float = 1.0,
                     skip_prob: float = 0.25) -> str:
    """A conv-stack-like chain with occasional skip connections."""
    lines: List[str] = []
    op_types = ["Conv2d", "BatchNorm2d", "ReLU", "MaxPool2d", "Linear"]
    for i in range(1, n_ops + 1):
        op_type = op_types[rng.integers(len(op_types))] if 1 < i < n_ops else (
            "Input" if i == 1 else "Linear")
        fwd = float(rng.uniform(0.2, 4.0)) * compute_scale
        bwd = fwd * float(rng.uniform(1.5, 2.5))
        activation = float(rng.uniform(0.05, 1.0)) * 1e9
        parameter = float(rng.uniform(0.01, 2.0)) * 1e9 if op_type in (
            "Conv2d", "Linear") else float(rng.uniform(0.001, 0.05)) * 1e9
        _emit_node(lines, i, op_type, fwd, bwd, activation, parameter)
    for i in range(1, n_ops):
        _emit_edge(lines, i, i + 1)
        if i + 2 <= n_ops and rng.random() < skip_prob:
            _emit_edge(lines, i, i + 2)
    return "\n".join(lines) + "\n"


def make_translation_profile(rng: np.random.Generator,
                             n_encoder: int,
                             n_decoder: int,
                             compute_scale: float = 1.0) -> str:
    """An encoder/decoder (GNMT-like) profile: two chains with a bridge and
    attention-style cross edges."""
    lines: List[str] = []
    n_ops = n_encoder + n_decoder
    for i in range(1, n_ops + 1):
        is_enc = i <= n_encoder
        op_type = "LSTMEnc" if is_enc else "LSTMDec"
        fwd = float(rng.uniform(0.5, 6.0)) * compute_scale
        bwd = fwd * float(rng.uniform(1.6, 2.2))
        activation = float(rng.uniform(0.1, 1.5)) * 1e9
        parameter = float(rng.uniform(0.2, 3.0)) * 1e9
        _emit_node(lines, i, op_type, fwd, bwd, activation, parameter)
    for i in range(1, n_encoder):
        _emit_edge(lines, i, i + 1)
    for i in range(n_encoder + 1, n_ops):
        _emit_edge(lines, i, i + 1)
    # bridge + attention cross edges
    _emit_edge(lines, n_encoder, n_encoder + 1)
    for i in range(n_encoder + 1, n_ops, 2):
        if i != n_encoder + 1:
            _emit_edge(lines, n_encoder, i)
    return "\n".join(lines) + "\n"


def generate_pipedream_txt_files(out_dir: str,
                                 n_cnn: int = 4,
                                 n_translation: int = 2,
                                 seed: int = 0,
                                 min_ops: int = 6,
                                 max_ops: int = 14,
                                 compute_scale: float = 1.0) -> List[str]:
    """Write a family of synthetic profiles to ``out_dir``; returns paths."""
    rng = np.random.default_rng(seed)
    pathlib.Path(out_dir).mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_cnn):
        n_ops = int(rng.integers(min_ops, max_ops + 1))
        path = os.path.join(out_dir, f"cnn_{i}.txt")
        with open(path, "w") as f:
            f.write(make_cnn_profile(rng, n_ops, compute_scale=compute_scale))
        paths.append(path)
    for i in range(n_translation):
        n_enc = int(rng.integers(max(3, min_ops // 2), max(4, max_ops // 2)))
        n_dec = int(rng.integers(max(3, min_ops // 2), max(4, max_ops // 2)))
        path = os.path.join(out_dir, f"translation_{i}.txt")
        with open(path, "w") as f:
            f.write(make_translation_profile(rng, n_enc, n_dec,
                                             compute_scale=compute_scale))
        paths.append(path)
    return paths
