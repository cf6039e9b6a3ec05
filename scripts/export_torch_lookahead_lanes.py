"""Export recorded inputs of the array lookahead engine with the JAX
engine's answers, for holding the port's K21 on a machine without JAX.

    python scripts/export_torch_lookahead_lanes.py [--out-dir DIR]

Writes ``lookahead_lanes_recorded.npz`` (default directory:
``ddls_tpu_torch/data``; format: ``ddls_tpu_torch/sim/fixture.py``), one
group of lanes per batched engine call, each built by the JAX package's
``build_lookahead_arrays`` and answered by its ``batched_lookahead_fn``
(float32):

* ``price32``, ``price72``, ``price128``: the candidates that
  ``candidate_pricing="jax"`` prices at the first decision from
  ``reset(7005)`` on the surfaces of ``ppo_price_mixed``,
  ``ppo_price_ft72`` and ``ppo_price_ft128``
  (``export_torch_checkpoints_fixture.SURFACES``: 32, 72 and 128
  servers), padded as that backend pads them;
* ``mounted32``: the first ``N_MOUNTED`` cache-miss lookaheads of
  ``use_jax_lookahead=True`` on ``env_load32`` (the cluster hook's
  ``pad_links=2`` and power-of-two buckets), under a fixed cycle over the
  valid actions, padded to the largest of their buckets;
* ``edge``: the hand-made lanes of ``edge_case_lanes`` (a stuck lane,
  zero durations, tied scores on a worker and on a channel, two channels
  per dep, no deps, an all-padding lane, random DAGs).

Deterministic: rerunning it reproduces every array bit for bit.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import types
from typing import Dict, List, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_checkpoints_fixture as ckpt_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import JAX_OUTPUTS, pack_lanes  # noqa: E402

OUT_NAME = "lookahead_lanes_recorded.npz"
SEED = 7005
PRICE_SURFACES = {"price32": "ppo_price_mixed", "price72": "ppo_price_ft72",
                  "price128": "ppo_price_ft128"}
N_MOUNTED = 8


def _env_config(name: str, **extra) -> dict:
    from ddls_tpu.config import load_config

    cfg = load_config(ckpt_export.CONFIG_PATH, "rllib_config",
                      ckpt_export.SURFACES[name])["env_config"]
    return dict(copy.deepcopy(cfg), **extra)


def _capture_builds(run) -> List:
    """The arrays every ``build_lookahead_arrays`` call made while
    ``run(built)`` ran, in call order (``built`` is the list they go
    into)."""
    import ddls_tpu.sim.jax_lookahead as jl

    built = []
    orig = jl.build_lookahead_arrays

    def spy(*args, **kwargs):
        arrays = orig(*args, **kwargs)
        built.append(arrays)
        return arrays

    jl.build_lookahead_arrays = spy
    try:
        run(built)
    finally:
        jl.build_lookahead_arrays = orig
    return built


def pricing_lanes(name: str) -> List:
    """The lanes of the JAX pricing backend at the first decision from
    ``reset(SEED)`` on checkpoint ``name``'s surface (the memo emptied
    for the call, so every candidate is priced, then put back)."""
    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.sim.candidate_pricing import price_candidate_degrees

    env = RampJobPartitioningEnvironment(**_env_config(name))
    env.reset(seed=SEED)
    saved = env.cluster.lookahead_cache
    env.cluster.lookahead_cache = {}
    try:
        return _capture_builds(
            lambda built: price_candidate_degrees(env, backend="jax"))
    finally:
        env.cluster.lookahead_cache = saved


def mounted_lanes(n_lanes: int = N_MOUNTED) -> List:
    """The cluster hook's first ``n_lanes`` array lookaheads on
    ``env_load32`` (``ppo_device_trained``'s surface) from
    ``reset(SEED)``, the actions cycling over the valid ones."""
    from ddls_tpu.envs import RampJobPartitioningEnvironment

    env = RampJobPartitioningEnvironment(**_env_config(
        "ppo_device_trained", use_jax_lookahead=True,
        use_native_lookahead=False))
    obs = env.reset(seed=SEED)

    def run(built):
        nonlocal obs
        i = 0
        while len(built) < n_lanes:
            valid = np.flatnonzero(obs["action_mask"])
            i += 1
            obs, _, done, _ = env.step(int(valid[i % len(valid)]))
            if done:
                raise RuntimeError("the episode ended before "
                                   f"{n_lanes} lookaheads")

    return _capture_builds(run)[:n_lanes]


def _lane(n_pad, e_pad, links, rem, worker, score, parents, deps):
    """A hand-made lane: ``deps`` = [(src, dst, rem, mutual, flow,
    score, channels)]."""
    n, m = len(rem), len(deps)
    lane = types.SimpleNamespace(
        op_remaining=np.zeros(n_pad, np.float32),
        op_valid=np.zeros(n_pad, bool),
        op_worker=np.full(n_pad, -1, np.int32),
        op_score=np.zeros(n_pad, np.float32),
        num_parents=np.zeros(n_pad, np.int32),
        dep_remaining=np.zeros(e_pad, np.float32),
        dep_valid=np.zeros(e_pad, bool),
        dep_src=np.zeros(e_pad, np.int32), dep_dst=np.zeros(e_pad, np.int32),
        dep_mutual=np.zeros(e_pad, bool), dep_is_flow=np.zeros(e_pad, bool),
        dep_score=np.zeros(e_pad, np.float32),
        dep_channel=np.full((e_pad, links), -1, np.int32))
    lane.op_remaining[:n] = rem
    lane.op_valid[:n] = True
    lane.op_worker[:n] = worker
    lane.op_score[:n] = score
    lane.num_parents[:n] = parents
    lane.dep_valid[:m] = True
    for j, (src, dst, r, mutual, flow, sc, chans) in enumerate(deps):
        lane.dep_src[j], lane.dep_dst[j] = src, dst
        lane.dep_remaining[j] = r
        lane.dep_mutual[j], lane.dep_is_flow[j] = mutual, flow
        lane.dep_score[j] = sc
        lane.dep_channel[j, :len(chans)] = chans
    return lane


def _random_dag(rng, n_pad, e_pad, links, n_workers, n_channels):
    """A random DAG lane: scores from a small set (ties on a worker and on
    a channel), some zero durations, some mutual and non-flow deps."""
    n = int(rng.randint(2, n_pad + 1))
    rem = np.round(rng.uniform(0, 3, n), 2) * (rng.uniform(size=n) > 0.2)
    worker = rng.randint(0, n_workers, n)
    score = rng.randint(1, 4, n)
    deps, parents = [], np.zeros(n, np.int32)
    pairs = [(u, v) for v in range(n) for u in range(v)]
    rng.shuffle(pairs)
    for u, v in pairs[:int(rng.randint(0, e_pad + 1))]:
        mutual = bool(rng.uniform() < 0.15)
        flow = bool(rng.uniform() < 0.7)
        chans = (list(rng.choice(n_channels, int(rng.randint(1, links + 1)),
                                 replace=False)) if flow else [])
        r = float(np.round(rng.uniform(0, 2), 2)) * (rng.uniform() > 0.2)
        deps.append((u, v, r, mutual, flow, int(rng.randint(1, 4)), chans))
        if not mutual:
            parents[v] += 1
    return _lane(n_pad, e_pad, links, rem, worker, score, parents, deps)


def edge_case_lanes() -> Tuple[List, int, int]:
    """(lanes, num_workers, num_channels): one batch of hand-made lanes at
    N = E = 16, L = 2, four workers and four channels."""
    n_pad, e_pad, links, w, c = 16, 16, 2, 4, 4
    lanes = [
        # stuck: op 1 waits for a parent dep that does not exist
        _lane(n_pad, e_pad, links, [1.0, 2.0], [0, 1], [2, 1], [0, 1], []),
        # stuck: a ready flow dep that rides no channel
        _lane(n_pad, e_pad, links, [1.0, 1.0], [0, 1], [2, 1], [0, 1],
              [(0, 1, 1.5, False, True, 1, [])]),
        # zero-duration ops and deps, flow and non-flow
        _lane(n_pad, e_pad, links, [0.0, 0.0, 1.0, 0.0], [0, 0, 1, 2],
              [4, 3, 2, 1], [0, 1, 1, 1],
              [(0, 1, 0.0, False, True, 3, [0]),
               (0, 2, 0.0, False, False, 2, []),
               (2, 3, 0.0, False, True, 1, [1])]),
        # tied scores on one worker (all selected) and on one channel
        # (both nominated)
        _lane(n_pad, e_pad, links, [1.0, 2.0, 0.5, 1.0], [0, 0, 0, 1],
              [5, 5, 5, 1], [0, 0, 0, 2],
              [(0, 3, 0.7, False, True, 2, [0]),
               (1, 3, 0.3, False, True, 2, [0])]),
        # f32 ties: scores that round to the same float32
        _lane(n_pad, e_pad, links, [1.0, 1.5], [0, 0],
              [np.float32(2 ** 25 + 1), np.float32(2 ** 25)], [0, 0], []),
        # L = 2: deps on two channels each, contending pairwise
        _lane(n_pad, e_pad, links, [0.5, 0.5, 0.5, 0.5], [0, 1, 2, 3],
              [4, 3, 2, 1], [0, 0, 2, 0],
              [(0, 2, 1.0, False, True, 3, [0, 1]),
               (1, 2, 2.0, False, True, 2, [1, 2]),
               (1, 3, 0.5, True, True, 1, [2, 3])]),
        # no deps
        _lane(n_pad, e_pad, links, [1.0, 2.0, 3.0], [0, 1, 0], [3, 2, 1],
              [0, 0, 0], []),
        # all padding: no valid op or dep
        _lane(n_pad, e_pad, links, [], [], [], [], []),
        # a short lane ahead of an all-padding tail
        _lane(n_pad, e_pad, links, [0.25], [3], [1], [0], []),
    ]
    rng = np.random.RandomState(SEED)
    lanes += [_random_dag(rng, n_pad, e_pad, links, w, c) for _ in range(7)]
    return lanes, w, c


def jax_answers(args, num_workers: int, num_channels: int
                ) -> Dict[str, np.ndarray]:
    """The JAX engine's float32 answers to the stacked lanes ``args``."""
    from ddls_tpu.sim.jax_lookahead import batched_lookahead_fn

    fn = batched_lookahead_fn(num_workers, num_channels)
    return {k: np.asarray(v) for k, v in zip(JAX_OUTPUTS, fn(*args))}


def export_group(lanes, num_workers: int, num_channels: int
                 ) -> Dict[str, np.ndarray]:
    from ddls_tpu_torch.sim.fixture import unpack_lanes
    from ddls_tpu_torch.sim.lookahead import ARG_NAMES

    packed = pack_lanes(lanes, num_workers, num_channels)
    arrays = unpack_lanes(packed)
    packed.update(jax_answers([arrays[a] for a in ARG_NAMES], num_workers,
                              num_channels))
    return packed


def _group_of(lanes) -> Dict[str, np.ndarray]:
    return export_group(lanes, max(a.num_workers for a in lanes),
                        max(a.num_channels for a in lanes))


def export_lanes() -> Dict[str, np.ndarray]:
    groups = {g: _group_of(pricing_lanes(name))
              for g, name in PRICE_SURFACES.items()}
    groups["mounted32"] = _group_of(mounted_lanes())
    groups["edge"] = export_group(*edge_case_lanes())
    return {f"{g}/{k}": v for g, packed in groups.items()
            for k, v in packed.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=ckpt_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    arrays = export_lanes()
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir, "lanes": {
        k.split("/")[0]: int(v.shape[0]) for k, v in arrays.items()
        if k.endswith("/n")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
