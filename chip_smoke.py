"""Drive the PyTorch port (``ddls_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; a failed phase raises and the script
exits non-zero (nothing is caught):

1. device  — requires CUDA; prints the card, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``; turns TF32 off.
2. build   — compiles the kernels from ddls_tpu_torch/kernels/csrc
   (one nvcc per source, all at once) and prints the -Xptxas -v summary.
3. kernels — records every kernel call of one forward of the shipped
   policy at the largest bucket (150 nodes, 512 edges) x max_batch 8 and
   at the smallest, on inputs that include nodes with no in-edges, padded
   edges pointing at node 0, a graph with zero real nodes and a fully
   masked action row; holds each kernel against its plain PyTorch version
   (abs and rel 1e-5; K2 and K4 also bitwise across two runs, K2 bit-equal
   to its plain version, also on a misaligned view of its messages, its
   plan query the Python mirror's) and times
   the kernel, the plain version and a one-call PyTorch yardstick.
   Then the same forward kernels where the PPO update runs them: every
   call of the training fixture's first minibatch forward (K1's nine at
   4,864 node and 16,384 edge rows), held and timed alike (the kernels
   line's "ln_linear_act (update)" row and the other rows' ``update``).
   Then K5–K8, the PPO update's kernels: every backward-kernel call of one
   minibatch step of the training fixture (128 real graphs at the (38,
   128) bucket), of one forward + backward of the edge-case batch at (150,
   512) (plus a node row whose LayerNorm variance clamps at exactly 0),
   the GAE of the fixture trajectory and the loss of the minibatch; each
   held against its plain version (abs 1e-5 of each output's own largest
   magnitude: float32 sums over up to 16,384 rows in another order; K5's
   plain version takes relu's kink decisions from K1's output on the same
   inputs), bitwise across two runs, and timed as above; each K5 call is
   one launch (its reduce over the CTAs inside it).
   Then K9, the rollout's sampling: its call in the rollout forward of
   recorded step 0 (8 envs) and of that batch with a fully masked row, a
   one-valid-action row, an exact tie and a near tie of ``m + g``; actions
   equal and logp within 1e-5 of its largest magnitude, bitwise across two
   runs, timed at the rollout shape.
   Then K10–K12, the IMPALA and PG updates' kernels: every call of one
   IMPALA and one PG full-batch update of the fixture trajectory (from the
   params after each recorded first JAX update) and edge cases the
   fixture cannot give (episode ends at t = 0, mid-way, T - 1 and on every
   step, T = 1, importance weights far above and below both clips, a
   fully masked row, a one-valid-action row, the dropped last step on and
   off); each held against its plain version (1e-5 of each output's
   largest magnitude; clip_rho_fraction may differ only by the rows whose
   rho lies within 1e-5 of the clip), bitwise across two runs, timed at
   the fixture's shapes.
   Then cluster — K24 and both K21 entries (per lane, indexed) spread each
   lane over a thread-block cluster: each at every cluster size 1-16
   against its plain version, bit for bit (ticks too), on the recorded
   replay's calls (8 lanes, decisions 0, 7 and 15; 1 and 2 lanes), the
   oracle step's 72 pricing rows and every recorded group of K21 lanes,
   in float32 and float64; then device ms a call (CUDA graph) at cluster
   sizes 1-16, the clusters of each size the card runs at once, and the
   size each wrapper chooses (the kernels line's ``cluster``).
   Then placement — K23, both entries, on fuzzed states at 1, 8 and 72
   rows, float32 and float64, on the shipped surface and on a 64-server
   ramp whose occupancy masks take two words: every call bit-equal to its
   plain version, and device ms a launch of each case.
4. serve   — the main path: the shipped ppo_price_mixed export through
   ``build_fleet(device="cuda")`` at max_batch 8 on the default ladder,
   the 64 fixture requests, launch counters reset just before and read
   just after; every answer must be the policy's and equal the recorded
   JAX action, the logits must match the recorded JAX logits within 1e-4,
   batched answers must be bit-equal to one-at-a-time ones, and a
   max_queue=2 pass must answer its overflow from FixedDegreePacking
   without dropping a request.
5. cli     — 8 fixture requests through ``python -m ddls_tpu_torch.serve``.
6. train   — the training main path: the fixture trajectory (8 envs x 64
   steps of env_load32_price_mixed under the shipped policy) staged on the
   card; the loss gradient of the first minibatch at the shipped params,
   before any optimiser arithmetic (each leaf within 1e-5 of its largest
   JAX gradient) and its metrics; ``PPOLearner.train_step`` with the
   recorded JAX permutations at 1 SGD iteration (params within 1e-5 of
   the recorded JAX params, metrics within 1e-6 + 1e-5 |JAX|) and at
   50 (reported against JAX; within 1e-2, a gross-failure guard), the
   launch counters reset just before the 50-iteration update and read
   just after (every kernel K1–K8 must have run), a second 50-iteration
   update bit-equal to the first, the time of each stage of a minibatch
   step (synchronised after each), the device busy share of 8 minibatch
   steps under torch.profiler, and one update at the canonical batch
   ([500, 8], tiled from the fixture, the learner's own generator).
7. rollout — the recorded collect (8 env_load32_price_mixed envs of the
   port's own simulator, 64 steps, the shipped policy, the recorded JAX
   uniforms) through K1–K3 and K9: observations, rewards and dones
   bit-equal to the recorded trajectory, actions equal, logp within 1e-5
   and values within 1e-5 of the largest recorded value; env steps/s, the
   wall split into env stepping and sampling, and candidate pricing's
   share of env stepping (its own timer); K9 launched once per
   step (the bootstrap values need no sample, so no K9 there).
8. eval    — ``RLEvalLoop`` with the shipped policy at a fixed
   interarrival time of 80 from seed 7005, greedy through K4: the episode
   record equal to the recorded JAX one, per-decision return > 0.2.
9. loop    — the PPO training path: ``python -m ddls_tpu_torch.train``
   (in this process) from the shipped export, 2 epochs at 8 envs x 64
   steps with the ppo.yaml update, one greedy evaluation episode and a
   checkpoint, with the launch counters reset just before and read just
   after (K1–K9 must all have run); run twice from one seed, bit-equal;
   then one warmed epoch under torch.profiler for the device busy share.
10. ac_train — the recorded JAX IMPALA and PG updates (3 successive
   updates each of the fixture trajectory from the shipped params, the
   shipped impala.yaml / pg.yaml): params within 1e-5 of each leaf's
   largest magnitude and metrics within 1e-5 of max(1, |JAX|) after each
   (clip_rho_fraction: rows with |rho - 1| <= 1e-5 excluded at update 1,
   exact at 2-3), V-trace's inputs and outputs (PG: the returns) against
   the recorded ones, launch counters around the 3 updates, a second run
   bit-equal; seconds per update and the device busy share of 3 updates.
11. ac_loop — the slice's main path: ``python -m ddls_tpu_torch.train``
   (in this process) from the shipped export, 2 epochs of the IMPALA
   config (32 envs x 15 steps) and 2 of the PG config (8 x 25), with
   checkpoints; launch counters reset just before each and read just after
   (K1–K6, K9, the algo's scan and K12 must all have run); each run twice
   from one seed, bit-equal.
12.–14. dqn_train, es_train, dqn_es_loop — the recorded JAX Ape-X DQN
   and ES updates (the ES updates within 1e-6, as K15 takes the jitted
   reference's arithmetic) and their loops (see each function).
   The loop phases 9, 11 and 14 run the sequential loop over in-process
   envs without per-epoch evaluation, as before the pipelined loop was
   ported; 15 and 16 run the configs' own modes.
15. pipeline — the slice's main path: the recorded JAX collect over 8
   subprocess envs on the shm transport reproduced by the port's
   ParallelVectorEnv (as [rollout]'s limits), its env steps/s beside
   [rollout]'s in-process figure; then ``python -m ddls_tpu_torch.train``
   on train_config_price_mixed as the config asks (pipelined, subprocess
   envs, an evaluation every epoch) at 8 envs x 64 steps, 2 epochs, with
   the launch counters around it (K1–K9, K17–K20), and the sequential
   loop on shm and the pipelined loop on the pipe transport, each
   bit-equal to it.
16. ring — the IMPALA config's loop at pipeline_depth 1 over 32
   subprocess envs: finite metrics, params ages 0 then 1, a 3-segment
   trajectory ring, no /dev/shm segment left.

17. lookahead — the shipped policy's in-process rollout (4
   env_load32_price_mixed envs, 32 steps) with ``candidate_pricing="jax"``
   and ``use_jax_lookahead=True`` on the card: K21 launched; after the
   counted window, each of its K21 calls run again (the same prices) and
   on the C++ engine (within rel 2e-4, abs 1e-5), each timed. Then
   lookahead_hook — the cluster hook alone on the card: the plain
   env_load32 surface (no pricing) with ``use_jax_lookahead=True``, 64
   FixedDegreePacking(8) decisions: K21 launched, the episode's stats
   equal to the C++ engine's (times within rel 1e-4).
18. checkpoints — all six shipped checkpoints on their own surfaces (32
   servers, 8/72/128 servers, the JCT-blocking reward, the plain
   observation): the recorded JAX greedy decisions through K1–K4 and K17,
   ``ppo_device_trained`` equal to FixedDegreePacking(8) over seed 7009
   and above 0.2 a decision at seed 7005.

19. episode — the device episode replay (``sim/device_env.py``) at full
   width on env_load32_price_mixed (45 configs, N 480, M 13,072), from
   ``ddls_tpu_torch/data/device_env_replay.npz``: the recorded JAX replays
   of 8 job banks x 400 decisions (float32) and of bank 0 (x64), each
   bank at 1 lane and all at 8 lanes (every decision's accept, cause and
   reward equal, t and jct bit-equal in float32 and within rel 1e-9 in
   float64, the counters equal; the other x64 lanes equal to each bank
   replayed alone), the 8-lane float32 replay counted (K21 with skip and
   K23-K25 once a decision); the first 16 decisions' kernel calls held
   against their plain versions in both float types; the same replay
   under torch.profiler (device ms a decision by kernel, K21's ticks,
   the busy share); then the port's own host env on that surface (pricing
   off), the reference test's mixed-action policy from seed 17, replayed
   in float64 decision for decision; and K22 over that episode's free
   grids, one launch a split value (counted), against its plain version
   and the host's C++ first fit.

20. device_collect — device-resident collection at full width on
   env_load32 with ppo_device_trained (2 lanes of the device collector's
   banks, float32): the recorded JAX collects (3 x 128 steps, the
   reference's DevicePPOCollector with the memo off, its uniforms) equal
   with the memo off (actions, rewards, dones, the compact fields and the
   episode counters equal, the rebuilt graph features bit-equal, logp
   within 1e-5, values and bootstrap values within 5e-5, the episode
   records equal) and, counted, with the memo on, bit-equal to it; K26,
   K25's prepare, K27, K28 and K25 with the reset held against their
   plain versions on every call of 16 steps in float32 and float64; one
   collect timed and one under torch.profiler (device ms a step by
   kernel, launches a step, the busy share).
21. policy_episode — ppo_device_trained greedy in-kernel (K4) in float64
   on the bank of the port's host env episode at seed 7009 on its
   surface: every decision equal to the host's.
22. oracle — the in-kernel OracleJCT episode (``make_oracle_episode_fn``:
   each step prices every degree of each lane's queued job with K23 on
   the state-lane index, K24, K21 without the memo and K29, chooses with
   K30, then decides as the replay) at full width on
   env_load32_price_mixed in float32, the memo on: bench.py's banks 0-7
   at 1 lane and at 8 lanes (counted), each lane equal to its bank alone,
   banks 0 and 1's first 64 steps equal to the recorded JAX float32
   episode (``ddls_tpu_torch/data/oracle_episode_recorded.npz``: actions,
   accept, cause, reward, t and jct bit-equal); every call of K23
   (indexed), K29 and K30 of the 8-lane episode bit-equal to its plain
   version, and the first steps' pricing equal to the recorded JAX
   ``price_all``; the float64 episode of the port's host OracleJCT
   episode (native pricing, a job every 80, seed 7005) decision for
   decision; decisions/s at 1 and 8 lanes and device ms a step by kernel
   under torch.profiler.
23. price_policy_episode — ppo_price_mixed greedy in-kernel with the
   observation's price block (``price_all`` and K26 with prices each
   step), float64, counted, on the bank of the port's host env episode
   under the same policy ([eval]'s surface and seed): every decision
   equal to the host's; then the recorded JAX float32 episode's first 64
   steps at full width: the trace equal, K26's price block bit-equal,
   every call of K23 (indexed), K29 and K26 (prices) bit-equal to its
   plain version.
24. device_train — ``python -m ddls_tpu_torch.train --config
   ddls_tpu_torch/data/train_config_ppo_device_load32.json --epochs 2`` in
   this process (the route that trained ppo_device_trained), counted, run
   twice from one seed and bit-equal; its collect, update and evaluation
   split.
25. scenario — the scenario specs' fingerprints, failure windows and
   loadgen traces against ``ddls_tpu_torch/data/scenario_recorded.npz``,
   and the port's conformance harness on the card (host_native, host_jax
   through K21, host_jitted through the device episode in float64,
   golden) on the failures and canonical specs.
26. scenario_episode — the full-width failure spec
   (``ddls_tpu_torch/data/scenario_failures_load32.json``) replayed
   through K25's scenario mode (the failure walk): the recorded JAX
   float32 banks bit for bit at 1 and 8 lanes (counted), each lane equal
   to its bank alone, bank 0 against the recorded x64 replay, the port's
   host env's episode in float64; every K25 call against its plain
   version, the walk's branches counted; C1's bank (three ticks of four
   completions); decisions/s and K25's device ms with and without the
   walk.
27. scenario_device_train — phase 24's CLI with ``epoch_loop.scenario``
   the full-width spec, run twice and bit-equal, every K25 call of the
   first run held against its plain version, the second counted.

Phase 20's reset part first reproduces the recorded JAX collect that
crosses both lanes' first reset (the device-collect recording's
``full/reset/``).

Phase 3 also holds K17 (both heads; recorded in the forward like K1–K4),
K18 (the heads' backward, its reduce inside its one launch), K19 (the
optimiser in one launch, the clip firing, not firing and at a tie; timed
at 1, 4, 8 and 16 CTAs besides its plan's) and K20 (the minibatch assembly,
exactly; its plan query, also at the Ape-X DQN's 512 rows) against their plain versions, and K21 (the array lookahead
engine) on the recorded lanes in float32 and float64: bit-equal to its
plain version and, in float32, to the recorded JAX answers; within 1e-9
of the C++ engine in float64. Its ``[wide]`` line holds K21, K25 and
K29 on 128 and 256 servers and K23 (both entries, float32 and float64; its
tables from global memory at 256) on 128, 160 and 256 against their plain
versions; K25's replay there takes its inputs from K23, K24 and K21. K6's
entries are timed at the update's minibatch step; K23's row carries its
three forms' device ms on the replay's call, and a row of its own holds
the global form at 256 servers.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import copy
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from ddls_tpu_torch import kernels  # noqa: E402
from ddls_tpu_torch.envs.baselines import FixedDegreePacking  # noqa: E402
from ddls_tpu_torch.envs.obs import pad_obs_to  # noqa: E402
from ddls_tpu_torch.models import gnn as gnn_mod  # noqa: E402
from ddls_tpu_torch.models import policy as policy_mod  # noqa: E402
from ddls_tpu_torch.models.convert import (params_from_flax,  # noqa: E402
                                           params_to_flax)
from ddls_tpu_torch.ops import segment as segment_mod  # noqa: E402
from ddls_tpu_torch.rl import actor_critic as ac_mod  # noqa: E402
from ddls_tpu_torch.rl import dqn as dqn_mod  # noqa: E402
from ddls_tpu_torch.rl import es as es_mod  # noqa: E402
from ddls_tpu_torch.rl import impala as impala_mod  # noqa: E402
from ddls_tpu_torch.rl import learner as learner_mod  # noqa: E402
from ddls_tpu_torch.rl import pg as pg_mod  # noqa: E402
from ddls_tpu_torch.rl import ppo as ppo_mod  # noqa: E402
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment  # noqa: E402
from ddls_tpu_torch.rl.fixture import (DQN_CONFIG_PATH,  # noqa: E402
                                       ES_CONFIG_PATH, IMPALA_CONFIG_PATH,
                                       PG_CONFIG_PATH, fixture_replay,
                                       load_ac_fixture, load_dqn_es_fixture,
                                       load_pipeline_fixture,
                                       load_rollout_fixture,
                                       load_train_config, load_train_fixture)
from ddls_tpu_torch.rl.shm import SlabSet  # noqa: E402
from ddls_tpu_torch.rl.rollout import (ParallelVectorEnv,  # noqa: E402
                                       RolloutCollector, VectorEnv,
                                       stack_obs)
from ddls_tpu_torch.serve import (BucketForward, ObsBucketer,  # noqa: E402
                                  build_fleet, default_buckets, load_export)
from ddls_tpu_torch.serve.fixture import (CHECKPOINT_NAMES,  # noqa: E402
                                          EXPORT_PATH, greedy_episode,
                                          load_checkpoint_fixture,
                                          load_requests)
from ddls_tpu_torch.sim import device_env  # noqa: E402
from ddls_tpu_torch.sim import fixture as device_env_fixture  # noqa: E402
from ddls_tpu_torch.sim import lookahead as lookahead_mod  # noqa: E402
from ddls_tpu_torch.sim.fixture import load_lookahead_lanes  # noqa: E402
from ddls_tpu_torch.train import RLEvalLoop  # noqa: E402
from ddls_tpu_torch.train.__main__ import build_loop  # noqa: E402
from ddls_tpu_torch.train.__main__ import main as train_main  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and fp32
# outside the tensor cores; every kernel here is fp32 CUDA-core work
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
TOL = 1e-5
# the recorded ES updates: K15 takes the jitted reference's arithmetic, so
# only adam's roundings separate them (3.5e-7 of a leaf's largest on the CPU)
ES_UPDATE_TOL = 1e-6
# the rollout's values against the recorded JAX ones: about 3x the largest
# difference seen (1.53e-5, 4 float32 steps of a value near 54)
VALUES_TOL = 5e-5
MAX_BATCH = 8
PAD_NODES, PAD_EDGES = 150, 512
# the simulator's kernels: only the env's array-engine options (K21:
# use_jax_lookahead, candidate_pricing="jax"), the device episode replay
# (K21-K25) and device collection (K26-K28 and K25's prepare) launch them,
# no host-collection learner's path
SIM_KERNELS = ("kernel_obs", "episode_prepare", "memo_probe", "memo_insert",
               "lookahead", "first_fit_block", "allocate_job",
               "price_and_score", "episode_step", "allocate_job_indexed",
               "price_reduce", "oracle_select", "kernel_obs_prices",
               "episode_step_scenario")
TIMED_ITERS = 200


# the script's start: each phase line carries the seconds since it
# (``at_s``), so the time a phase took is the difference to the line before
START = time.monotonic()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.monotonic() - START}), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ------------------------------------------------------------------ timing
def eager_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Per-call time of ``fn`` as a caller pays it (host launch cost
    included): CUDA events around ``iters`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so host
    launch cost drops out. The warm-up calls run on the capture stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def forced_ms(name: str, value, fn) -> float:
    """``device_ms`` of ``fn`` with ``value`` forced on kernel ``name``'s
    form (``kernels._forcing``)."""
    with kernels._forcing(name, value):
        return device_ms(fn)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ------------------------------------------- per-kernel plain, yardstick
def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def k1_parts(args, kwargs):
    a, ln_w, ln_b, w, bias, activation = args
    idx, b = kwargs.get("idx"), kwargs.get("b")
    b_width = kwargs.get("b_width", 0)
    rows = idx.shape[0] if idx is not None else a.shape[0]
    k_in, fo = w.shape[1], w.shape[0]
    act = gnn_mod.get_activation(activation)

    def library():
        x = a if idx is None else a[idx.long()]
        x = torch.cat([x, b if b is not None
                       else x.new_zeros((rows, b_width))], dim=1)
        y = torch.nn.functional.layer_norm(x, (k_in,), ln_w, ln_b, eps=1e-6)
        return act(torch.nn.functional.linear(y, w, bias))

    out_bytes = rows * fo * 4
    work = bound_ms(_nbytes(a, idx, b, ln_w, ln_b, w, bias) + out_bytes,
                    rows * (2 * k_in * fo + 8 * k_in + 2 * fo))
    shape = (f"rows={rows} in={a.shape[1]}"
             f"+{b.shape[1] if b is not None else b_width}"
             f"{' gather' if idx is not None else ''} out={fo}")
    return (lambda: gnn_mod.ln_linear_act_plain(
        *args, idx=idx, b=b, b_width=b_width), library, work, shape)


def k2_parts(args, kwargs):
    msg, self_msg, row_ptr, col, node_mask = args
    n_nodes, f = self_msg.shape
    nnz = int(row_ptr[-1])
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(n_nodes, device=msg.device),
                                  deg)
    edges = col[:nnz].long()
    ones = torch.ones(nnz, device=msg.device)

    def library():
        totals = self_msg.new_zeros((n_nodes, f)).index_add_(
            0, dst, msg[edges])
        counts = self_msg.new_zeros(n_nodes).index_add_(0, dst, ones)
        return ((totals + self_msg) / (counts + 1.0)[:, None]
                * node_mask[:, None])

    work = bound_ms(nnz * f * 4 + nnz * 4 + _nbytes(self_msg, row_ptr,
                                                    node_mask)
                    + n_nodes * f * 4, nnz * f + 3 * n_nodes * f)
    return (lambda: segment_mod.csr_segment_mean_plain(*args), library,
            work, f"nodes={n_nodes} edges={nnz} f={f}")


def k3_parts(args, kwargs):
    emb, node_mask, graph_emb = args
    b, n, f = emb.shape
    g = graph_emb.shape[1]

    def library():
        total = (emb * node_mask[..., None]).sum(1)
        count = node_mask.sum(1).clamp(min=1.0)
        return torch.cat([total / count[:, None], graph_emb], 1)

    work = bound_ms(_nbytes(emb, node_mask, graph_emb) + b * (f + g) * 4,
                    2 * b * n * f)
    return (lambda: segment_mod.masked_mean_pool_concat_plain(*args),
            library, work, f"graphs={b} nodes={n} f={f} g={g}")


def k4_parts(args, kwargs):
    logits, mask = args
    rows, a = logits.shape

    def library():
        masked = logits.masked_fill(mask == 0, policy_mod.FLOAT32_MIN)
        return masked, masked.argmax(1)

    work = bound_ms(_nbytes(logits, mask) + rows * a * 4 + rows * 8,
                    3 * rows * a)
    return (lambda: policy_mod.mask_logits_argmax_plain(*args), library,
            work, f"rows={rows} actions={a}")


def _heads_composition(x, logit_layers, value_layers, activation):
    """The heads as ``torch.addmm`` and the activation, layer by layer:
    K17's and K18's library yardstick."""
    act = gnn_mod.get_activation(activation)

    def run(layers):
        h = x
        for i, (w, b) in enumerate(layers):
            h = torch.addmm(b, h, w.t())
            if i < len(layers) - 1:
                h = act(h)
        return h

    return run(logit_layers), run(value_layers)[:, 0]


def _heads_work(x, logit_layers, value_layers, backward=False):
    """K17's (or K18's) bound: x, every weight and bias and the outputs
    (K18: x, weights, the output gradients, d x and the parameter
    gradients) moved once; 2 operations per weight and row (K18: 4, and
    the recomputed forward's 2)."""
    rows = x.shape[0]
    weights = [t for layer in logit_layers + value_layers for t in layer]
    n_w = sum(w.shape[0] * w.shape[1] for w, _ in logit_layers
              + value_layers)
    a = logit_layers[-1][0].shape[0]
    if backward:
        nbytes = 2 * _nbytes(x, *weights) + rows * (a + 1) * 4
        return bound_ms(nbytes, 6 * rows * n_w)
    return bound_ms(_nbytes(x, *weights) + rows * (a + 1) * 4,
                    2 * rows * n_w)


def k17_parts(args, kwargs):
    x, logit_layers, value_layers, activation = args
    widths = [w.shape[0] for w, _ in logit_layers]
    return (lambda: policy_mod.mlp_heads_plain(*args),
            lambda: _heads_composition(*args),
            _heads_work(x, logit_layers, value_layers),
            f"rows={x.shape[0]} in={x.shape[1]} logit={widths} "
            f"value={[w.shape[0] for w, _ in value_layers]}")


# (module whose global the forward calls, attribute, parts builder)
KERNEL_SITES = {
    "ln_linear_act": (gnn_mod, "ln_linear_act", k1_parts),
    "csr_segment_mean": (gnn_mod, "csr_segment_mean", k2_parts),
    "masked_mean_pool_concat": (policy_mod, "masked_mean_pool_concat",
                                k3_parts),
    "mask_logits_argmax": (policy_mod, "mask_logits_argmax", k4_parts),
    "mlp_heads": (policy_mod, "mlp_heads", k17_parts),
}


def record_calls(model, batch):
    """One forward with every kernel wrapper recorded: {kernel: [(wrapper,
    args, kwargs), ...]} in call order."""
    calls = {name: [] for name in KERNEL_SITES}
    originals = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append((fn, args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    for name, (mod, attr, _) in KERNEL_SITES.items():
        originals[name] = getattr(mod, attr)
        setattr(mod, attr, recorder(name, originals[name]))
    try:
        model.flat_batched(batch)
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr, _) in KERNEL_SITES.items():
            setattr(mod, attr, originals[name])
    return calls


def _rel(diff: float, ref: torch.Tensor) -> float:
    """``diff`` over the largest magnitude of ``ref`` (0 when both are 0)."""
    scale = float(ref.double().abs().max())
    return diff / scale if scale else (0.0 if diff == 0 else float("inf"))


def max_err(out, ref):
    """(max abs error, max of each output's error over its largest
    magnitude) of the kernel's outputs against the plain version's."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = rel = 0.0
    for o, r in zip(outs, refs):
        require(o.shape == r.shape and o.dtype == r.dtype,
                f"kernel output {o.shape}/{o.dtype} vs plain "
                f"{r.shape}/{r.dtype}")
        if o.dtype.is_floating_point:
            require(torch.allclose(o, r, rtol=TOL, atol=TOL),
                    "kernel disagrees with its plain version beyond 1e-5")
            diff = float((o.double() - r.double()).abs().max())
            err, rel = max(err, diff), max(rel, _rel(diff, r))
        else:
            require(torch.equal(o, r), "kernel's integer output differs "
                                       "from its plain version's")
    return err, rel


def edge_case_batch(requests, n_pad, e_pad, device="cuda"):
    """Eight fixture requests padded to (n_pad, e_pad), with slot 6's action
    mask all zero and slot 7 holding a graph with zero real nodes."""
    obs = [pad_obs_to(r, n_pad, e_pad) for r in requests[:MAX_BATCH]]
    obs[6] = dict(obs[6], action_mask=np.zeros_like(obs[6]["action_mask"]))
    obs[7] = pad_obs_to(dict(obs[7], node_split=np.array([0], np.int32),
                             edge_split=np.array([0], np.int32)),
                        n_pad, e_pad)
    stacked = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    host = policy_mod.prepare_flat_batch(stacked)
    deg = np.diff(host["csr_row_ptr"])
    require(bool(((deg == 0) & (host["node_mask"] == 1)).any()),
            "no real node without in-edges in the edge-case batch")
    require(int(stacked["edge_split"].min()) < e_pad,
            "no padded edges in the edge-case batch")
    return policy_mod.batch_to_device(host, torch.device(device))


def _forward_result():
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
            "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "library_device_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
            "calls_per_forward": 0, "shapes": []}


def hold_forward_calls(name, recorded, res, timed):
    """Each recorded call of forward kernel ``name`` against its plain
    version (K2 and K4 also bitwise across two runs), its errors into
    ``res``; with ``timed``, each call's times and bound added into
    ``res`` too."""
    require(len(recorded) > 0, f"forward made no {name} call")
    parts = KERNEL_SITES[name][2]
    bound_total = {"bytes": 0.0, "operations": 0.0}
    for fn, args, kwargs in recorded:
        plain, library, (bound, bound_by), shape = parts(args, kwargs)
        out = fn(*args, **kwargs)
        ref = plain()
        torch.cuda.synchronize()
        err, rel = max_err(out, ref)
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_rel_err"] = max(res["max_rel_err"], rel)
        if name in ("csr_segment_mean", "mask_logits_argmax"):
            again = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            agains = again if isinstance(again, tuple) else (again,)
            require(all(torch.equal(x, y) for x, y in zip(outs, agains)),
                    f"{name} is not bitwise repeatable")
        if name == "csr_segment_mean":
            check_k2_plan(fn, args, out, ref, res, timed)
        if not timed:
            continue
        res["calls_per_forward"] += 1
        res["shapes"].append(shape)
        res["ms"] += device_ms(lambda: fn(*args, **kwargs))
        res["eager_ms"] += eager_ms(lambda: fn(*args, **kwargs))
        res["plain_ms"] += eager_ms(plain, iters=20)
        res["library_ms"] += eager_ms(library)
        res["library_device_ms"] += device_ms(library)
        res["bound_ms"] += bound
        bound_total[bound_by] += bound
    if timed:
        res["bound_by"] = max(bound_total, key=bound_total.get)


def _same_bits(x, y) -> bool:
    return x.shape == y.shape and torch.equal(
        x.contiguous().view(torch.int32), y.contiguous().view(torch.int32))


def check_k2_plan(fn, args, out, ref, res, timed):
    """K2's call ``args`` beyond its tolerance: its output, and its output
    on a view of the messages offset by one float, bit-equal to the plain
    version's ``ref``; the C entry's plan (``ddls_csr_segment_mean_plan``)
    equal to ``ops/segment.py``'s mirror; with ``timed``, the plan added
    into ``res["plans"]``."""
    msg, self_msg = args[:2]
    n_nodes, f = self_msg.shape
    shifted = torch.empty(msg.numel() + 1, device=msg.device)[1:].view(
        msg.shape)
    shifted.copy_(msg)
    moved = fn(shifted, *args[1:])
    torch.cuda.synchronize()
    require(_same_bits(out, ref) and _same_bits(moved, ref),
            "K2 (as given or on misaligned messages) is not bit-equal to "
            "its plain version")
    got = kernels.query("csr_segment_mean", "ddls_csr_segment_mean_plan", f,
                        n_nodes)
    want = segment_mod.csr_segment_mean_plan(f, n_nodes)
    require(got == want.packed(), f"K2's plan {got} is not the mirror's "
                                  f"{want} (f={f})")
    if timed:
        res.setdefault("plans", []).append(
            f"f={f}: {want.group} lanes a node, {want.chunks} floats a "
            f"lane, {want.blocks} CTAs")


def check_kernels(model_gpu, requests):
    """Phase 3: per kernel, max error over both buckets and its times at
    the largest bucket (summed over the calls of one forward)."""
    results = {name: _forward_result() for name in KERNEL_SITES}
    buckets = default_buckets(PAD_NODES, PAD_EDGES)
    for timed, (n_pad, e_pad) in ((True, buckets[-1]), (False, buckets[0])):
        batch = edge_case_batch(requests, n_pad, e_pad)
        calls = record_calls(model_gpu, batch)
        for name, recorded in calls.items():
            hold_forward_calls(name, recorded, results[name], timed)
    return results


def check_update_forward_kernels(params, fx):
    """Phase 3, the forward kernels where the PPO update runs them: every
    call of the training fixture's first minibatch forward (128 graphs at
    the (38, 128) bucket: 4,864 node rows and 16,384 edge rows, the shipped
    policy's widths; K1's nine calls) against its plain version, timed as
    the serving calls are and summed over the forward's calls."""
    model, _, _ = load_export(EXPORT_PATH)
    cfg = fx["cfg"]
    learner = ppo_mod.PPOLearner(model, cfg, device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    batch = learner.minibatch(staged, idx)
    calls = record_sites(KERNEL_SITES,
                         lambda: learner.model.flat_batched(batch))
    results = {}
    for name, recorded in calls.items():
        if recorded:
            results[name] = _forward_result()
            hold_forward_calls(name, recorded, results[name], True)
    require("ln_linear_act" in results, "the update's forward made no K1 "
                                        "call")
    return results


# ------------------------------------------------ K5–K8: the PPO update
def profiled_device_ms(fn, iters: int = 20) -> float:
    """Per-call device time of ``fn`` from torch.profiler: the CUDA kernel
    time of ``iters`` calls over ``iters``. Used for the autograd
    yardsticks, whose backward runs on autograd's own thread and cannot be
    captured in a CUDA graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters


def _flat(out):
    return [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]


def max_err_scaled(out, ref):
    """(max abs error, max relative error) of the kernel's outputs against
    the plain version's: each floating output is required within 1e-5 of
    its own largest magnitude (exactly equal where that is 0); integer
    outputs must be equal."""
    outs, refs = _flat(out), _flat(ref)
    require(len(outs) == len(refs), "kernel and plain differ in outputs")
    err = rel = 0.0
    for o, r in zip(outs, refs):
        require(o.shape == r.shape and o.dtype == r.dtype,
                f"kernel output {o.shape}/{o.dtype} vs plain "
                f"{r.shape}/{r.dtype}")
        if not o.numel():
            continue
        if o.dtype.is_floating_point:
            diff = float((o.double() - r.double()).abs().max())
            ratio = _rel(diff, r)
            require(ratio <= TOL, f"kernel disagrees with its plain version: "
                                  f"{diff} is {ratio} of the output's "
                                  f"largest magnitude, over {TOL}")
            err, rel = max(err, diff), max(rel, ratio)
        else:
            require(torch.equal(o, r), "integer outputs differ")
    return err, rel


def _grad_leaves(*tensors):
    return [t.detach().clone().requires_grad_(True) if t is not None
            else None for t in tensors]


def k5_parts(args, kwargs):
    a, ln_w, ln_b, w, bias, activation, dout = args
    idx, b = kwargs.get("idx"), kwargs.get("b")
    b_width = kwargs.get("b_width", 0)
    want_dx = kwargs.get("want_dx", True)
    want_db = kwargs.get("want_db", True) and b is not None
    rows, fo = dout.shape
    k_in = w.shape[1]
    fa = a.shape[1]
    act = gnn_mod.get_activation(activation)
    # K1's output on the same inputs: the plain version takes relu's kink
    # decisions from it, as K5 (which recomputes K1's pre-activations) does
    k1_out = gnn_mod._ln_linear_act_cuda(a, ln_w, ln_b, w, bias, activation,
                                         idx, b, b_width)
    la, lb, lw, lbn, lwt, lbias = _grad_leaves(a, b, ln_w, ln_b, w, bias)
    x = la if idx is None else la[idx.long()]
    x = torch.cat([x, lb if lb is not None
                   else x.new_zeros((rows, b_width))], dim=1)
    y = act(torch.nn.functional.linear(torch.nn.functional.layer_norm(
        x, (k_in,), lw, lbn, eps=1e-6), lwt, lbias))
    leaves = [t for t in (la, lb, lw, lbn, lwt, lbias) if t is not None]

    def library():
        return torch.autograd.grad(y, leaves, dout, retain_graph=True)

    # the function's bytes: its inputs, the per-row gradients this call
    # asks for (dx of the left half unless want_dx is False, db only when
    # b is given) and the parameter gradients; K5's per-CTA partial rows,
    # summed inside its launch, are its own intermediate
    n_params = fo * k_in + fo + 2 * k_in
    nbytes = (_nbytes(a, idx, b, ln_w, ln_b, w, bias, dout)
              + (rows * fa * 4 if want_dx else 0)
              + (rows * (k_in - fa) * 4 if want_db else 0) + n_params * 4)
    work = bound_ms(nbytes, rows * (6 * k_in * fo + 20 * k_in))
    shape = (f"rows={rows} in={fa}+{b.shape[1] if b is not None else b_width}"
             f"{' gather' if idx is not None else ''} out={fo}")
    return (lambda: gnn_mod.ln_linear_act_bwd_plain(
        a, ln_w, ln_b, w, bias, activation, dout, idx=idx, b=b,
        b_width=b_width, out=k1_out), library, work, shape)


def k5_compare(out, ref):
    """K5's wrapper skips the outputs autograd does not need."""
    return tuple(None if o is None else r for o, r in zip(out, ref))


def k6m_parts(args, kwargs):
    dout, row_ptr, edge_dst, node_mask = args
    n_nodes, f = dout.shape
    n_edges = edge_dst.shape[0]
    deg = (row_ptr[1:] - row_ptr[:-1]).to(dout.dtype)
    safe = torch.clamp(edge_dst.long(), min=0)
    real = (edge_dst >= 0).to(dout.dtype)[:, None]

    def library():
        d_tot = dout * node_mask[:, None] / (deg + 1)[:, None]
        return d_tot.index_select(0, safe) * real, d_tot

    nbytes = (_nbytes(dout, row_ptr, edge_dst, node_mask)
              + (n_edges + n_nodes) * f * 4)
    return (lambda: segment_mod.csr_segment_mean_bwd_plain(*args), library,
            bound_ms(nbytes, 2 * (n_edges + n_nodes) * f),
            f"nodes={n_nodes} edges={n_edges} f={f}")


def k6s_parts(args, kwargs):
    g, row_ptr, col = args
    n_nodes, f = row_ptr.shape[0] - 1, g.shape[1]
    nnz = int(row_ptr[-1])
    dst = torch.repeat_interleave(torch.arange(n_nodes, device=g.device),
                                  (row_ptr[1:] - row_ptr[:-1]).long())
    edges = col[:nnz].long()

    def library():
        return g.new_zeros((n_nodes, f)).index_add_(0, dst, g[edges])

    nbytes = nnz * f * 4 + nnz * 4 + _nbytes(row_ptr) + n_nodes * f * 4
    return (lambda: segment_mod.csr_segment_sum_plain(*args), library,
            bound_ms(nbytes, nnz * f), f"nodes={n_nodes} edges={nnz} f={f}")


def k6p_parts(args, kwargs):
    dout, node_mask, f = args
    b, n = node_mask.shape

    def library():
        count = node_mask.sum(1).clamp(min=1.0)
        return ((dout[:, :f] / count[:, None])[:, None, :]
                * node_mask[..., None]), dout[:, f:]

    nbytes = _nbytes(dout, node_mask) + b * n * f * 4 + dout[:, f:].numel() * 4
    return (lambda: segment_mod.masked_mean_pool_concat_bwd_plain(*args),
            library, bound_ms(nbytes, 2 * b * n * f),
            f"graphs={b} nodes={n} f={f}")


def k7_parts(args, kwargs):
    rewards, values, dones, last_values, gamma, lam, normalize = args
    t_len, lanes = rewards.shape

    def library():
        adv, tgt = ppo_mod.compute_gae(rewards, values, dones, last_values,
                                       gamma, lam)
        std, mean = torch.std_mean(adv, correction=0)
        return (adv - mean) / (std + 1e-8), tgt

    nbytes = _nbytes(rewards, values, dones, last_values) + 2 * t_len * \
        lanes * 4
    return (lambda: ppo_mod.gae_normalize_plain(*args), library,
            bound_ms(nbytes, 16 * t_len * lanes), f"T={t_len} B={lanes}")


def k8_parts(args, kwargs):
    logits, values, actions, old_logp, old_values, advs, targets, kl, cfg = \
        args
    m, a = logits.shape

    @torch.enable_grad()
    def library():
        lo = logits.detach().requires_grad_(True)
        va = values.detach().requires_grad_(True)
        logp = torch.log_softmax(lo, -1).gather(1, actions.long()[:, None])
        ratio = torch.exp(logp[:, 0] - old_logp)
        surr = torch.min(ratio * advs, torch.clamp(
            ratio, 1 - cfg.clip_param, 1 + cfg.clip_param) * advs)
        vf = torch.max((va - targets) ** 2, (old_values + torch.clamp(
            va - old_values, -cfg.vf_clip_param, cfg.vf_clip_param)
            - targets) ** 2)
        total = (-surr.mean() + kl * (old_logp - logp[:, 0]).mean()
                 + cfg.vf_loss_coeff * 0.5 * vf.mean()
                 - cfg.entropy_coeff * ppo_mod.categorical_entropy(lo).mean())
        return torch.autograd.grad(total, (lo, va))

    nbytes = _nbytes(logits, values, actions, old_logp, old_values, advs,
                     targets, kl) + m * a * 4 + m * 4 + 7 * 4
    return (lambda: ppo_mod.ppo_loss_grad_plain(*args)[1:], library,
            bound_ms(nbytes, 40 * m * a), f"rows={m} actions={a}")


def k8_compare(out, ref):
    return out[1:], ref


# (module whose global the update calls, attribute, parts function)
TRAIN_SITES = {
    "ln_linear_act_bwd": (gnn_mod, "ln_linear_act_bwd", k5_parts),
    "csr_segment_mean_bwd": (segment_mod, "csr_segment_mean_bwd",
                             k6m_parts),
    "csr_segment_sum": (gnn_mod, "csr_segment_sum", k6s_parts),
    "masked_mean_pool_concat_bwd": (segment_mod,
                                    "masked_mean_pool_concat_bwd",
                                    k6p_parts),
    "gae_normalize": (ppo_mod, "gae_normalize", k7_parts),
    "ppo_loss": (ppo_mod, "_ppo_loss_cuda", k8_parts),
}


def _snapshot(x):
    return x.detach().clone() if torch.is_tensor(x) else x


def record_sites(sites, run):
    """``run()`` with every wrapper in ``sites`` recorded: {kernel:
    [(wrapper, args, kwargs), ...]} in call order, each tensor argument
    copied as the wrapper got it (a later in-place update of a parameter
    does not reach the recorded inputs)."""
    calls = {name: [] for name in sites}
    originals = {}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append((fn, tuple(_snapshot(x) for x in args),
                                {k: _snapshot(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)
        return wrapped

    for name, (mod, attr, _) in sites.items():
        originals[name] = getattr(mod, attr)
        setattr(mod, attr, recorder(name, originals[name]))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, originals[name])
    return calls


def _edge_case_train_batch(requests, model_gpu, cfg):
    """The edge-case batch at the largest bucket, with node 0 of graph 0
    holding five equal features (its LayerNorm variance is exactly 0, the
    clamp's tie), and loss inputs made from seed 0: one forward + backward
    through the kernels."""
    n_pad, e_pad = PAD_NODES, PAD_EDGES
    batch = edge_case_batch(requests, n_pad, e_pad)
    batch["node_features"][0, 0] = 2.0
    rng = np.random.default_rng(0)
    m = batch["node_features"].shape[0]
    mask = batch["action_mask"].cpu().numpy()
    actions = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                        for r in mask], np.int32)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    loss_in = (torch.as_tensor(actions, device="cuda"),
               dev(rng.normal(-1.5, 0.3, m)), dev(rng.normal(50, 1, m)),
               dev(rng.normal(0, 1, m)), dev(rng.normal(50, 2, m)))
    kl = torch.tensor(0.2, device="cuda")

    def run():
        logits, values, _ = model_gpu.flat_batched(batch)
        total, _ = ppo_mod.ppo_loss(logits, values, *loss_in, kl, cfg)
        torch.autograd.grad(total, list(model_gpu.parameters()))
    return run


def check_train_kernels(params, requests, fx):
    """Phase 3, K5–K8: per kernel, the max error over the fixture
    minibatch step and the edge-case batch, and its times at the fixture
    minibatch step (summed over that kernel's calls in one step; K7 once
    per update)."""
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
                      "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "library_device_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": None, "calls_per_step": 0, "shapes": []}
               for name in TRAIN_SITES}
    model, _, _ = load_export(EXPORT_PATH)
    cfg = fx["cfg"]
    learner = ppo_mod.PPOLearner(model, cfg, device="cuda")
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    state = learner.init_state({k: v.cuda() for k, v in params.items()})
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")

    def fixture_step():  # the loss and gradients, no optimiser step
        advs, targets = learner.flat_advantages(staged)
        learner.loss_and_grads(state, staged, idx, advs, targets)

    with torch.enable_grad():
        edge_run = _edge_case_train_batch(requests, learner.model, cfg)
        recorded_runs = [(True, record_sites(TRAIN_SITES, fixture_step)),
                         (False, record_sites(TRAIN_SITES, edge_run))]
    for timed, calls in recorded_runs:
        for name, recorded in calls.items():
            if name == "gae_normalize" and not timed:
                continue
            require(len(recorded) > 0, f"the update made no {name} call")
            res = results[name]
            parts = TRAIN_SITES[name][2]
            bound_total = {"bytes": 0.0, "operations": 0.0}
            for fn, args, kwargs in recorded:
                with torch.enable_grad():  # K5's yardstick's graph
                    plain, library, (bound, bound_by), shape = parts(
                        args, kwargs)
                before = kernels.launch_counts()
                out = fn(*args, **kwargs)
                if name == "ln_linear_act_bwd":  # the reduce inside
                    after = kernels.launch_counts()
                    require({k: v - before[k] for k, v in after.items()
                             if v != before[k]} == {name: 1},
                            "K5 is not one launch a call")
                again = fn(*args, **kwargs)
                ref = plain()
                torch.cuda.synchronize()
                if name == "ln_linear_act_bwd":
                    ref = k5_compare(out, ref)
                elif name == "ppo_loss":
                    out, ref = k8_compare(out, ref)
                    again = again[1:]
                err, rel = max_err_scaled(out, ref)
                res["max_abs_err"] = max(res["max_abs_err"], err)
                res["max_rel_err"] = max(res["max_rel_err"], rel)
                require(all(torch.equal(x, y) for x, y in
                            zip(_flat(out), _flat(again))),
                        f"{name} is not bitwise repeatable")
                if not timed:
                    continue
                res["calls_per_step"] += 1
                res["shapes"].append(shape)
                res["ms"] += device_ms(lambda: fn(*args, **kwargs))
                res["eager_ms"] += eager_ms(lambda: fn(*args, **kwargs))
                res["plain_ms"] += eager_ms(plain, iters=20)
                res["library_ms"] += eager_ms(library, iters=50)
                res["library_device_ms"] += profiled_device_ms(library)
                res["bound_ms"] += bound
                bound_total[bound_by] += bound
            if timed:
                res["bound_by"] = max(bound_total, key=bound_total.get)
    return results


def _jax_errors(state, run):
    tree = params_to_flax(state.state_dict())
    require(sorted(tree) == sorted(run["params"]),
            "trained params do not map onto the JAX tree")
    return max(float(np.abs(tree[k] - run["params"][k]).max())
               for k in tree)


def _metric_errors(metrics, want):
    """Each metric's abs error against the JAX one; fails unless within
    1e-6 + 1e-5 |JAX value| (kl sits near 0: its rounding is that of
    log-probabilities of size ~1, hence the absolute term)."""
    errs = {k: abs(float(metrics[k]) - want[k]) for k in want}
    for k, e in errs.items():
        require(e <= 1e-6 + 1e-5 * abs(want[k]),
                f"metric {k} off the JAX one by {e}")
    return errs


def check_first_gradient(learner, staged, params, fx):
    """The loss gradient at the shipped params on the first minibatch of
    the 1-iteration update, before any optimiser arithmetic (adam and the
    global-norm clip would hide a gradient off by a constant factor),
    against the recorded ``jax.value_and_grad``: each leaf within 1e-5 of
    its largest JAX gradient (float32 sums in another order), and the
    minibatch's metrics."""
    state = learner.init_state(params)
    advs, targets = learner.flat_advantages(staged)
    idx = torch.as_tensor(
        fx["runs"][1]["perms"][0][:learner.cfg.sgd_minibatch_size],
        device="cuda")
    metrics, grads = learner.loss_and_grads(state, staged, idx, advs,
                                            targets)
    got = params_to_flax(dict(zip(state.names, grads)))
    ref = fx["mb0"]["grads"]
    require(sorted(got) == sorted(ref), "gradients do not map onto the "
                                        "JAX tree")
    rel = {k: float(np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max())
           for k in ref}
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 1e-5, f"first-minibatch gradient of {worst} off "
                                f"JAX's by {rel[worst]} of its largest")
    errs = _metric_errors(dict(zip(ppo_mod.METRIC_KEYS, metrics)),
                          fx["mb0"]["metrics"])
    return {"grads_max_rel_err": rel[worst], "grads_worst_leaf": worst,
            "metrics_abs_err": errs}


def profile_steps(learner, staged, state, perm, n_steps: int = 8):
    """``n_steps`` minibatch steps of a warmed learner under
    torch.profiler: device time over wall time (a lower bound: the
    profiler's own host cost is inside the wall) and the largest device
    totals by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = learner.cfg
    mb = cfg.sgd_minibatch_size
    advs, targets = learner.flat_advantages(staged)
    n_mb = perm.shape[0] // mb

    def steps():
        for k in range(n_steps):
            j = k % n_mb
            learner._minibatch_step(state, staged, perm[j * mb:(j + 1) * mb],
                                    advs, targets)

    steps()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        steps()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    events = 0
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            events += 1
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time_total / 1e3)
    device_ms_total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_ms": device_ms_total,
            "device_ms_per_step": device_ms_total / n_steps,
            "device_events_per_step": events / n_steps,
            "device_busy_share": device_ms_total / wall_ms,
            "top_device_ms": {k[:80]: v for k, v in top}}


def step_breakdown(learner, staged, state, perm, n_steps: int = 20):
    """Where one minibatch step's time goes: each stage of
    ``PPOLearner._minibatch_step`` run with a synchronise after it, over
    ``n_steps`` steps (ms per step, host and device together; the
    synchronises serialise what the unsynchronised step overlaps)."""
    cfg = learner.cfg
    mb = cfg.sgd_minibatch_size
    advs, targets = learner.flat_advantages(staged)
    n_mb = perm.shape[0] // mb
    stages = ("assembly", "forward", "loss", "backward", "optimizer")
    totals = dict.fromkeys(stages, 0.0)
    for k in range(n_steps + 2):  # the first two steps warm up
        idx = perm[(k % n_mb) * mb:(k % n_mb + 1) * mb]
        marks = [time.monotonic()]
        batch = learner.minibatch(staged, idx)
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        logits, values, _ = learner.model.flat_batched(batch)
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        total, _ = ppo_mod.ppo_loss(
            logits, values, staged["actions"].index_select(0, idx),
            staged["old_logp"].index_select(0, idx),
            staged["old_values"].index_select(0, idx),
            advs.index_select(0, idx), targets.index_select(0, idx),
            state.kl_coeff, cfg)
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        grads = list(torch.autograd.grad(total, state.params))
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        with torch.no_grad():
            learner._apply_optimizer(state, grads)
        state.step += 1
        torch.cuda.synchronize()
        marks.append(time.monotonic())
        if k >= 2:
            for i, name in enumerate(stages):
                totals[name] += (marks[i + 1] - marks[i]) * 1e3
    return {name: v / n_steps for name, v in totals.items()}


def tiled_traj(fx, t_len: int):
    """The fixture trajectory tiled along T to ``t_len`` steps (the
    canonical 500 x 8 = 4,000-sample batch); no episode ends."""
    reps = -(-t_len // fx["traj"]["rewards"].shape[0])

    def tile(x):
        return np.concatenate([x] * reps, axis=0)[:t_len]

    traj = {"obs": {k: tile(v) for k, v in fx["traj"]["obs"].items()}}
    for key in ("actions", "logp", "values", "rewards", "dones"):
        traj[key] = tile(fx["traj"][key])
    return traj


def phase_train(params, fx, card):
    """Phase 6: the PPO update on the card against the recorded JAX one."""
    import dataclasses

    model, _, _ = load_export(EXPORT_PATH)
    cfg50 = fx["cfg"]
    out = {"card": card}
    with torch.enable_grad():
        learner1 = ppo_mod.PPOLearner(
            copy.deepcopy(model), dataclasses.replace(cfg50, num_sgd_iter=1),
            device="cuda")
        t0 = time.monotonic()
        staged = learner1.stage_traj(fx["traj"], fx["last_values"])
        torch.cuda.synchronize()
        out["stage_s"] = time.monotonic() - t0
        out["bucket"] = [staged.n_nodes, staged.n_edges]
        gpu_params = {k: v.cuda() for k, v in params.items()}
        out["first_minibatch"] = check_first_gradient(learner1, staged,
                                                      gpu_params, fx)
        run1 = fx["runs"][1]
        state, metrics = learner1.train_step(learner1.init_state(gpu_params),
                                             staged, perms=run1["perms"])
        err1 = _jax_errors(state, run1)
        out["iter1_params_max_abs_err"] = err1
        require(err1 <= 1e-5, f"1-iteration update off the recorded JAX "
                              f"params by {err1}")
        out["iter1_metrics_abs_err"] = _metric_errors(metrics,
                                                      run1["metrics"])
        require(float(state.kl_coeff) == run1["kl_coeff"],
                "1-iteration kl_coeff differs from JAX's")

        learner = ppo_mod.PPOLearner(copy.deepcopy(model), cfg50,
                                     device="cuda")
        run50 = fx["runs"][50]
        snapshots = []
        for attempt in range(2):
            state = learner.init_state(gpu_params)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            state, metrics = learner.train_step(state, staged,
                                                perms=run50["perms"])
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            if attempt == 0:
                launches = kernels.launch_counts()
                out["train_step_s"] = seconds
                out["minibatch_steps"] = state.step
                out["ms_per_minibatch_step"] = seconds / state.step * 1e3
                out["iter50_params_max_abs_err"] = _jax_errors(state, run50)
                out["iter50_metrics"] = {k: float(v)
                                         for k, v in metrics.items()}
                out["iter50_jax_metrics"] = run50["metrics"]
            else:
                out["train_step_s_again"] = seconds
            snapshots.append({k: v.clone() for k, v in
                              state.state_dict().items()})
        for name, n in launches.items():
            require(n > 0 or name in SAMPLE_SITES or name in AC_SITES
                    or name in DQN_ES_SITES or name in SIM_KERNELS,
                    f"kernel {name} was not launched by train_step")
        require(out["iter50_params_max_abs_err"] <= 1e-2,
                "50-iteration update far off the recorded JAX params")
        require(all(torch.equal(v, snapshots[1][k])
                    for k, v in snapshots[0].items()),
                "two 50-iteration updates differ in their params")
        out["launches"] = launches
        # a minibatch step's launches of the port's kernels (K18 and K19
        # one each: their reduces run inside their launches)
        out["kernel_launches_per_minibatch_step"] = {
            k: v / state.step for k, v in launches.items() if v}
        # (gae_normalize's one launch an update inside)
        out["kernel_launches_a_minibatch_step"] = sum(
            launches.values()) / state.step
        perm0 = torch.as_tensor(run50["perms"][0], device="cuda")
        out["step_breakdown_ms"] = step_breakdown(
            learner, staged, learner.init_state(gpu_params), perm0)
        out["profiled"] = profile_steps(
            learner, staged, learner.init_state(gpu_params), perm0)

        # the canonical batch: 4,000 samples, 31 minibatches per epoch
        canon = ppo_mod.PPOLearner(copy.deepcopy(model), cfg50,
                                   device="cuda")
        t0 = time.monotonic()
        staged_c = canon.stage_traj(tiled_traj(fx, 500), fx["last_values"])
        torch.cuda.synchronize()
        stage_c = time.monotonic() - t0
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = canon.init_state(gpu_params)
        t0 = time.monotonic()
        state, metrics = canon.train_step(state, staged_c, generator=gen)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                "non-finite metrics at the canonical batch")
        out["canonical"] = {"samples": staged_c.t_len * staged_c.lanes,
                            "stage_s": stage_c,
                            "train_step_s": seconds,
                            "minibatch_steps": state.step,
                            "ms_per_minibatch_step":
                                seconds / state.step * 1e3}
    emit("train", **out)
    return launches


# ------------------------------------------------- K9: rollout sampling
def k9_parts(args, kwargs):
    logits, mask, u = args
    rows, a = logits.shape

    def library():
        m = logits.masked_fill(mask == 0, policy_mod.FLOAT32_MIN)
        actions = (m - torch.log(-torch.log(u))).argmax(1)
        logp = torch.log_softmax(m, 1).gather(1, actions[:, None])[:, 0]
        return actions, logp

    # three [B, A] float32/int32 inputs read once, two [B] outputs
    # written once; ~8 operations per entry (mask, two logs, add, max,
    # sub, exp, sum)
    work = bound_ms(_nbytes(logits, mask, u) + rows * 8, 8 * rows * a)
    return (lambda: policy_mod.mask_sample_logp_plain(*args), library,
            work, f"rows={rows} actions={a}")


SAMPLE_SITES = {
    "mask_sample_logp": (policy_mod, "mask_sample_logp", k9_parts),
}


def sample_edge_cases(logits, mask, u):
    """Rows that probe K9's edges, appended to a real rollout step: a fully
    masked row, a one-valid-action row, an exact tie of ``m + g`` (the
    lower index must win) and a near tie one float32 step apart."""
    a = logits.shape[1]
    ext_l = logits[:4].clone()
    ext_m = torch.ones_like(mask[:4])
    ext_u = u[:4].clone()
    ext_m[0] = 0
    ext_m[1] = 0
    ext_m[1, a // 2] = 1
    # tie rows: every other entry 24 below, beyond what any float32 uniform
    # can close (its Gumbel draw lies in [-4.5, 16.7])
    ext_l[2] = -20.0
    ext_l[2, 3] = ext_l[2, 5] = 4.0
    ext_u[2, 3] = ext_u[2, 5] = 0.75
    ext_l[3] = -20.0
    ext_l[3, 2] = 4.0
    ext_l[3, 6] = float(np.nextafter(np.float32(4.0), np.float32(5.0)))
    ext_u[3, 2] = ext_u[3, 6] = 0.75
    return (torch.cat([logits, ext_l]), torch.cat([mask, ext_m]),
            torch.cat([u, ext_u]))


def check_sample_kernel(params, fx, uniforms):
    """Phase 3, K9: its calls in the rollout forward of recorded step 0 (8
    envs) and of that batch with the edge-case rows; held against its
    plain version (actions equal, logp within 1e-5 of its largest
    magnitude), bitwise across two runs, timed at the rollout shape."""
    model, _, _ = load_export(EXPORT_PATH)
    learner = ppo_mod.PPOLearner(model, fx["cfg"], device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    obs = {k: v[0] for k, v in fx["traj"]["obs"].items()}
    u = torch.as_tensor(uniforms[0], device="cuda")
    calls = record_sites(SAMPLE_SITES,
                         lambda: learner.sample_actions(obs, u))
    fn, args, kwargs = calls["mask_sample_logp"][0]
    res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "calls_per_step":
           len(calls["mask_sample_logp"])}
    for timed, call_args in ((True, args), (False,
                                            sample_edge_cases(*args))):
        plain, library, (bound, bound_by), shape = k9_parts(call_args, {})
        out = fn(*call_args)
        again = fn(*call_args)
        ref = plain()
        lib_out = library()
        torch.cuda.synchronize()
        err, rel = max_err_scaled(out, ref)
        require(torch.equal(out[0].long(), lib_out[0]),
                "K9's actions differ from the library composition's")
        require(all(torch.equal(x, y) for x, y in zip(out, again)),
                "mask_sample_logp is not bitwise repeatable")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_rel_err"] = max(res["max_rel_err"], rel)
        if not timed:
            n = args[0].shape[0]
            require(int(out[0][n]) == 0 and abs(
                float(out[1][n]) + float(np.log(args[0].shape[1]))) < TOL,
                    "a fully masked row must give action 0, logp -log(A)")
            require(int(out[0][n + 1]) == args[0].shape[1] // 2
                    and float(out[1][n + 1]) == 0.0,
                    "a one-valid-action row must give it with logp 0")
            require(int(out[0][n + 2]) == 3, "an exact tie must go to the "
                                             "lower index")
            require(int(out[0][n + 3]) == 6, "a near tie must go to the "
                                             "larger value")
            continue
        res.update(shape=shape, bound_ms=bound, bound_by=bound_by,
                   ms=device_ms(lambda: fn(*call_args)),
                   eager_ms=eager_ms(lambda: fn(*call_args)),
                   plain_ms=eager_ms(plain, iters=50),
                   library_ms=eager_ms(library),
                   library_device_ms=device_ms(library))
    return res


# ----------------------------------- K10–K12: the IMPALA and PG updates
def k10_parts(args, kwargs):
    (behavior, target, rewards, values, dones, last, gamma, clip_rho,
     clip_pg_rho) = args
    t_len, lanes = rewards.shape
    # five [T, B] inputs and [B] read once, two [T, B] outputs written once;
    # ~20 operations per entry (exp, two clips, the delta, the carry, vs,
    # pg_adv)
    work = bound_ms(_nbytes(behavior, target, rewards, values, dones, last)
                    + 2 * t_len * lanes * 4, 20 * t_len * lanes)
    return (lambda: impala_mod.vtrace_plain(*args), None, work,
            f"T={t_len} B={lanes}")


def k11_parts(args, kwargs):
    rewards, dones, gamma = args
    t_len, lanes = rewards.shape
    work = bound_ms(_nbytes(rewards, dones) + t_len * lanes * 4,
                    4 * t_len * lanes)
    return (lambda: pg_mod.reward_to_go_plain(*args), None, work,
            f"T={t_len} B={lanes}")


def k12l_parts(args, kwargs):
    logits, actions = args
    rows, a = logits.shape

    def library():  # the log-probability as one call (its negation)
        return torch.nn.functional.cross_entropy(logits, actions.long(),
                                                 reduction="none")

    work = bound_ms(_nbytes(logits, actions) + rows * 4, 4 * rows * a)
    return (lambda: ac_mod.ac_logp_plain(*args), library, work,
            f"rows={rows} actions={a}")


def k12_parts(args, kwargs):
    logits, values, actions, weights, vs, behavior, t_len, drop_last = \
        args[:8]
    rows, a = logits.shape
    kept = rows - rows // t_len if drop_last else rows
    # the kept rows' inputs read once (a dropped row's inputs are not
    # needed), every row's gradients and the metrics written once; ~20
    # operations per kept entry (log-softmax, entropy and their backward)
    nbytes = (kept * (a + 5) * 4 + rows * (a + 1) * 4
              + (len(ac_mod.AC_METRIC_KEYS) + 1) * 4)
    return (lambda: ac_mod.ac_loss_grad_plain(*args), None,
            bound_ms(nbytes, 20 * kept * a),
            f"rows={rows} actions={a} T={t_len} drop_last={drop_last}")


# (module whose global the update calls, attribute, parts function); the
# IMPALA update calls ac_logp, vtrace and ac_loss, the PG update
# reward_to_go and ac_loss
AC_SITES = {
    "vtrace": (impala_mod, "vtrace", k10_parts),
    "reward_to_go": (pg_mod, "reward_to_go", k11_parts),
    "ac_logp": (impala_mod, "ac_logp", k12l_parts),
    "ac_loss": (ac_mod, "_ac_loss_cuda", k12_parts),
}


def scan_edge_cases():
    """[T, B] inputs that the recorded trajectory (no episode end, every
    importance weight ~1 at the first update) cannot give: episode ends at
    t = 0, mid-way and T - 1 (lane 0) and on every step (lane 1), weights
    far above and below both clips, at T = 64 and T = 1 (8 lanes) and at
    the loops' shapes, [15, 32] (IMPALA) and [25, 8] (PG)."""
    cases = []
    for t_len, lanes in ((64, 8), (1, 8), (15, 32), (25, 8)):
        g = torch.Generator(device="cpu").manual_seed(t_len)
        behavior = torch.randn(t_len, lanes, generator=g) * 0.5 - 1.5
        target = behavior + torch.randn(t_len, lanes, generator=g) * 3.0
        dones = (torch.rand(t_len, lanes, generator=g) < 0.05).float()
        dones[[0, t_len // 2, t_len - 1], 0] = 1.0
        dones[:, 1] = 1.0
        rewards = torch.randn(t_len, lanes, generator=g)
        values = torch.randn(t_len, lanes, generator=g) * 3 + 50
        last = torch.randn(lanes, generator=g) + 50
        cases.append([x.cuda() for x in (behavior, target, rewards, values,
                                         dones, last)])
    return cases


def loss_edge_cases(logits, values, actions, weights, vs, behavior, t_len):
    """The recorded update's loss inputs with row 0 fully masked and row 1
    left one valid action (its logp is then exactly 0), with the dropped
    last step on and off; and their first 480 and 200 rows as the loops'
    shapes, 32 lanes x 15 steps (IMPALA, last step dropped) and 8 x 25
    (PG, its coefficients)."""
    logits = logits.clone()
    logits[0] = policy_mod.FLOAT32_MIN
    logits[1] = policy_mod.FLOAT32_MIN
    logits[1, int(actions[1])] = 1.5
    args = (logits, values, actions, weights, vs, behavior)
    cases = [(*args, t_len, drop, 0.5, 0.01, 1.0) for drop in (True, False)]
    cases.append((*(x[:480].contiguous() for x in args), 15, True, 0.5,
                  0.01, 1.0))
    cases.append((*(x[:200].contiguous() for x in args), 25, False, 0.0,
                  0.0, 1.0))
    return cases


def undecided_rows(args) -> int:
    """Kept rows of an ac_loss call whose importance weight lies within
    1e-5 of the clip: ``rho > clip`` there is a coin flip between two
    correct forwards (at the fixture's first update every row is one)."""
    logits, _, actions, _, _, behavior, t_len, drop_last = args[:8]
    keep = ac_mod.keep_rows(logits.shape[0], t_len, drop_last,
                            logits.device)
    rho = torch.exp(ac_mod.ac_logp_plain(logits, actions) - behavior)[keep]
    return int((torch.abs(rho - args[10]) <= 1e-5).sum())


def k12_compare(out, ref, args):
    """K12 against its plain version: every output within 1e-5 of its
    largest magnitude, except clip_rho_fraction, which may differ by the
    undecided rows' share (``undecided_rows``) and nothing more."""
    frac = ac_mod.AC_METRIC_KEYS.index("clip_rho_fraction")
    rows, t_len, drop_last = out[2].shape[0], args[6], args[7]
    kept = rows - rows // t_len if drop_last else rows
    require(abs(float(out[1][frac]) - float(ref[1][frac]))
            <= undecided_rows(args) / kept,
            "ac_loss's clip_rho_fraction differs from the plain version's "
            "beyond its undecided rows")
    others = [i for i in range(len(ac_mod.AC_METRIC_KEYS)) if i != frac]
    return ((out[0], out[1][others], out[2], out[3]),
            (ref[0], ref[1][others], ref[2], ref[3]))


def check_ac_kernels(train_fx, ac_fx):
    """Phase 3, K10–K12: every call of one IMPALA and one PG update of the
    fixture trajectory (from the params after each recorded first update,
    where the importance weights have moved off 1) and of the edge cases;
    each held against its plain version (floats within 1e-5 of each
    output's largest magnitude; clip_rho_fraction per ``k12_compare``),
    bitwise across two runs, and its first call (its one call in an IMPALA
    or a PG update) timed at the fixture's shapes."""
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
                      "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                      "library_device_ms": None, "bound_ms": 0.0,
                      "bound_by": None, "calls_per_step": 0, "shapes": []}
               for name in AC_SITES}
    model, _, _ = load_export(EXPORT_PATH)
    calls = {name: [] for name in AC_SITES}
    for algo, cls in (("impala", impala_mod.ImpalaLearner),
                      ("pg", pg_mod.PGLearner)):
        learner = cls(copy.deepcopy(model), ac_fx[algo]["cfg"],
                      device="cuda")
        staged = learner.stage_traj(train_fx["traj"],
                                    train_fx["last_values"])
        state = learner.init_state({
            k: v.cuda() for k, v in params_from_flax(
                ac_fx[algo]["steps"][0]["params"], model).items()})
        with torch.enable_grad():
            recorded = record_sites(
                AC_SITES, lambda: learner.loss_and_grads(state, staged))
        for name, got in recorded.items():
            calls[name] += got
    edge = {"vtrace": [], "reward_to_go": [], "ac_logp": [], "ac_loss": []}
    for behavior, target, rewards, values, dones, last in scan_edge_cases():
        edge["vtrace"].append((behavior, target, rewards, values, dones,
                               last, 0.99, 1.0, 0.8))
        edge["reward_to_go"].append((rewards, dones, 0.99))
    fn, args, _ = calls["ac_loss"][0]  # IMPALA's
    edge["ac_loss"] = loss_edge_cases(*args[:7])
    edge["ac_logp"] = [(x[0], x[2]) for x in edge["ac_loss"][:1]]
    for name, res in results.items():
        require(len(calls[name]) > 0, f"the updates made no {name} call")
        parts = AC_SITES[name][2]
        fn = calls[name][0][0]
        bound_total = {"bytes": 0.0, "operations": 0.0}
        # timed: the kernel's first call, in one update (ac_loss's second
        # call, PG's, is held against its plain version but not timed)
        runs = [(i == 0, a) for i, (_, a, _) in enumerate(calls[name])] + [
            (False, a) for a in edge[name]]
        for timed, args in runs:
            plain, library, (bound, bound_by), shape = parts(args, {})
            out = fn(*args)
            again = fn(*args)
            ref = plain()
            torch.cuda.synchronize()
            err, rel = max_err_scaled(*(k12_compare(out, ref, args)
                                        if name == "ac_loss" else (out, ref)))
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_rel_err"] = max(res["max_rel_err"], rel)
            require(all(torch.equal(x, y) for x, y in
                        zip(_flat(out), _flat(again))),
                    f"{name} is not bitwise repeatable")
            if name == "ac_loss" and not timed:
                dropped = out[2].reshape(-1, args[6], out[2].shape[1])[:, -1]
                require(bool((dropped == 0).all()) == args[7],
                        "ac_loss's dropped last step has a gradient")
            if name == "ac_logp" and not timed:
                require(float(out[1]) == 0.0, "a one-valid-action row's "
                                              "logp must be exactly 0")
            if not timed:
                continue
            res["calls_per_step"] += 1
            res["shapes"].append(shape)
            res["ms"] += device_ms(lambda: fn(*args))
            res["eager_ms"] += eager_ms(lambda: fn(*args))
            res["plain_ms"] += eager_ms(plain, iters=20)
            if library is not None:
                res["library_ms"] = (res["library_ms"] or 0.0) + eager_ms(
                    library)
                res["library_device_ms"] = (res["library_device_ms"]
                                            or 0.0) + device_ms(library)
            res["bound_ms"] += bound
            bound_total[bound_by] += bound
        res["bound_by"] = max(bound_total, key=bound_total.get)
    return results


# ------------------------------------------- rollout, eval, loop phases
def phase_rollout(params, fx, uniforms, card):
    """Phase 7: the recorded collect (8 env_load32_price_mixed envs seeded
    0-7, 64 steps, the shipped policy, the recorded JAX uniforms) through
    the port's simulator, K1-K3 and K9: observations, rewards and dones
    bit-equal to the recorded trajectory, actions equal, logp within 1e-5
    and values within VALUES_TOL absolute (float32 sums in another order;
    values reach ~54, where one float32 step is 3.8e-6)."""
    cfg = load_train_config()
    model, _, _ = load_export(EXPORT_PATH)
    learner = ppo_mod.PPOLearner(model, fx["cfg"], device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    ref = fx["traj"]
    t_len, n_envs = ref["rewards"].shape
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(cfg["env_config"])) for _ in range(n_envs)],
        seeds=list(range(n_envs)))
    vec.reset()
    collector = RolloutCollector(vec, learner, t_len)
    # candidate pricing's share of env stepping: the env's pricing call
    # (all valid degrees on the C++ engine), timed where it runs
    pricing = {"s": 0.0, "calls": 0}
    price = RampJobPartitioningEnvironment._price_candidates

    def timed_price(env):
        t_start = time.perf_counter()
        price(env)
        pricing["s"] += time.perf_counter() - t_start
        pricing["calls"] += 1

    RampJobPartitioningEnvironment._price_candidates = timed_price
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = collector.collect(noise=uniforms)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
    finally:
        RampJobPartitioningEnvironment._price_candidates = price
    traj = out["traj"]
    for key, value in traj["obs"].items():
        require(np.array_equal(value, ref["obs"][key]),
                f"rollout obs {key} differs from the recorded trajectory")
    for key in ("rewards", "dones", "actions"):
        require(np.array_equal(traj[key], ref[key]),
                f"rollout {key} differ from the recorded trajectory")
    logp_err = float(np.abs(traj["logp"] - ref["logp"]).max())
    val_err = float(np.abs(traj["values"] - ref["values"]).max())
    last_err = float(np.abs(out["last_values"] - fx["last_values"]).max())
    require(logp_err <= TOL, f"rollout logp off JAX's by {logp_err}")
    require(max(val_err, last_err) <= VALUES_TOL,
            f"rollout values off JAX's by {max(val_err, last_err)}")
    require(launches["mask_sample_logp"] == t_len,
            f"K9 launched {launches['mask_sample_logp']} times in "
            f"{t_len} rollout steps")
    for name in ("ln_linear_act", "csr_segment_mean",
                 "masked_mean_pool_concat"):
        require(launches[name] > 0, f"the rollout did not launch {name}")
    steps = t_len * n_envs
    measured = {"env_steps_per_s": steps / wall}
    emit("rollout", card=card, env_steps=steps, wall_s=wall,
         env_steps_per_s=steps / wall, env_s=out["timing"]["env_s"],
         sample_s=out["timing"]["sample_s"],
         env_ms_per_step=out["timing"]["env_s"] / t_len * 1e3,
         pricing_s=pricing["s"], pricing_calls=pricing["calls"],
         pricing_ms_per_decision=pricing["s"] / pricing["calls"] * 1e3,
         sample_ms_per_step=out["timing"]["sample_s"] / t_len * 1e3,
         logp_max_abs_err=logp_err, values_max_abs_err=val_err,
         last_values_max_abs_err=last_err, values_tol=VALUES_TOL,
         launches={k: v for k, v in launches.items() if v})
    return measured


def phase_eval(recorded, card):
    """Phase 8: the port's RLEvalLoop with the shipped policy at a fixed
    interarrival time of 80, seed 7005, greedy through K4: the episode
    record equal to the recorded JAX one (length exact, return within
    1e-6, every other field within 1e-9 relative) and per-decision return
    above 0.2 (``tests/test_shipped_checkpoint.py``'s floor)."""
    want, seed, interarrival = (recorded["record"], recorded["seed"],
                                recorded["interarrival"])
    cfg = load_train_config()
    cfg["env_config"]["jobs_config"]["job_interarrival_time_dist"].update(
        {"_target_": "ddls_tpu.demands.distributions.Fixed",
         "val": interarrival})
    cfg["epoch_loop"].update(num_envs=1, rollout_length=1,
                             use_parallel_envs=False)
    loop = build_loop(cfg, "cuda", EXPORT_PATH)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        got = RLEvalLoop(loop).run(seed=seed)["episode"]
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
    finally:
        loop.close()
    require(got["episode_length"] == want["episode_length"],
            f"eval episode length {got['episode_length']} != JAX's "
            f"{want['episode_length']}")
    require(abs(got["episode_return"] - want["episode_return"]) <= 1e-6,
            f"eval return {got['episode_return']} != JAX's "
            f"{want['episode_return']}")
    require(sorted(got) == sorted(want), "eval record keys differ")
    for key, value in want.items():
        require(abs(got[key] - value) <= 1e-9 * max(1.0, abs(value)),
                f"eval {key} {got[key]} != JAX's {value}")
    per_decision = got["episode_return"] / max(got["episode_length"], 1)
    require(per_decision > 0.2, f"eval per-decision return {per_decision}")
    require(launches["mask_logits_argmax"] == got["episode_length"],
            "the greedy eval did not take one K4 launch per decision")
    emit("eval", card=card, seed=seed, interarrival=interarrival,
         record=got, per_decision=per_decision, wall_s=wall,
         ms_per_decision=wall / got["episode_length"] * 1e3,
         launches={k: v for k, v in launches.items() if v})


def _run_train_cli(argv):
    """``python -m ddls_tpu_torch.train`` in this process (so its kernel
    launches count): its JSON lines."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(argv)
    require(rc == 0, f"ddls_tpu_torch.train exited {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln]


def _deterministic(line):
    """An output line without its wall-clock fields and its checkpoint's
    directory."""
    drop = ("timing", "epoch_time", "run_time", "checkpoint")
    return {k: v for k, v in line.items() if k not in drop}


def profile_epoch(cfg_path: str):
    """One warmed epoch of the loop under torch.profiler: device time over
    wall time (the profiler's host cost is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with open(cfg_path) as fh:
        cfg = json.load(fh)
    loop = build_loop(cfg, "cuda", EXPORT_PATH)
    try:
        loop.run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            results = loop.run()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    finally:
        loop.close()
    device_ms_total = sum(e.device_time_total for e in prof.events()
                          if e.device_type == DeviceType.CUDA) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms_total,
            "device_busy_share": device_ms_total / wall_ms,
            "timing": results["timing"]}


def phase_loop(card):
    """Phase 9, the slice's main path: ``python -m ddls_tpu_torch.train``
    from the shipped export for 2 epochs at 8 envs x 64 steps under the
    ppo.yaml update (minibatch 128, 50 SGD iterations), then one greedy
    evaluation episode and a checkpoint; the launch counters reset just
    before and read just after (every kernel K1-K9 must have run). Run
    twice from one seed: the output lines and the checkpoints bit-equal.
    Then one more warmed epoch under torch.profiler."""
    import tempfile

    cfg = _earlier_slice(load_train_config())
    cfg["epoch_loop"].update(num_envs=8, rollout_length=64)
    runs, launches = [], None
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "train_config.json")
        with open(cfg_path, "w") as fh:
            json.dump(cfg, fh)
        for attempt in range(2):
            ckpt_dir = os.path.join(tmp, f"run{attempt}")
            argv = ["--config", cfg_path, "--epochs", "2", "--device",
                    "cuda", "--init-export", EXPORT_PATH,
                    "--checkpoint-dir", ckpt_dir, "--eval-episodes", "1",
                    "--eval-seed", "1799"]
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.monotonic()
            lines = _run_train_cli(argv)
            wall = time.monotonic() - t0
            if attempt == 0:
                launches = kernels.launch_counts()
            state = torch.load(os.path.join(lines[-1]["checkpoint"],
                                            "train_state.pt"),
                               weights_only=True)
            runs.append((lines, state, wall))
        profiled = profile_epoch(cfg_path)
    for name, n in launches.items():
        require(n > 0 or name in AC_SITES or name in DQN_ES_SITES
                or name in SIM_KERNELS,
                f"kernel {name} was not launched by the loop")
    (lines0, state0, wall0), (lines1, state1, _) = runs
    require([_deterministic(x) for x in lines0]
            == [_deterministic(x) for x in lines1],
            "two runs of the loop from one seed printed different results")
    require(all(torch.equal(a, b) for key in ("params", "mu", "nu")
                for a, b in zip(state0[key], state1[key]))
            and torch.equal(state0["kl_coeff"], state1["kl_coeff"])
            and state0["step"] == state1["step"],
            "two runs of the loop from one seed saved different states")
    epochs = lines0[:-1]
    for line in epochs:
        require(all(np.isfinite(v) for v in line["learner"].values()),
                "non-finite learner metrics")
    emit("loop", card=card, wall_s=wall0, epochs=len(epochs),
         env_steps_per_epoch=epochs[0]["env_steps_this_iter"],
         epoch_s=[x["epoch_time"] for x in epochs],
         timing=[x["timing"] for x in epochs],
         learner=[x["learner"] for x in epochs],
         evaluation=lines0[-1]["evaluation"],
         profiled_epoch=profiled,
         launches={k: v for k, v in launches.items() if v})
    return launches


# ------------------------------------------- the IMPALA and PG phases
def _ac_learner(algo, ac_fx, model):
    cls = impala_mod.ImpalaLearner if algo == "impala" else pg_mod.PGLearner
    return cls(copy.deepcopy(model), ac_fx[algo]["cfg"], device="cuda")


def phase_ac_train(params, train_fx, ac_fx, card):
    """Phase 10: the recorded JAX IMPALA and PG updates on the card, 3
    successive updates each from the shipped params on the fixture
    trajectory: params within 1e-5 of each leaf's largest magnitude and
    metrics within 1e-5 of max(1, |JAX value|) after every update (IMPALA's
    clip_rho_fraction per the rule below), IMPALA's V-trace inputs and
    outputs against the recorded ones; the launch counters reset just
    before the 3 updates and read just after; a second run bit-equal.

    clip_rho_fraction counts rho > 1 strictly: at update 1 the params are
    the behaviour policy's and every rho is 1 to within float32 rounding,
    so the rows with |rho - 1| <= 1e-5 (by JAX's rho) are excluded there,
    counted and reported, and the rest must agree row by row; at updates 2
    and 3 the metric must equal JAX's."""
    model, _, _ = load_export(EXPORT_PATH)
    gpu_params = {k: v.cuda() for k, v in params.items()}
    behavior = train_fx["traj"]["logp"][:-1]
    out = {"card": card}
    launches = {}
    with torch.enable_grad():
        for algo in ("impala", "pg"):
            fx = ac_fx[algo]
            learner = _ac_learner(algo, ac_fx, model)
            t0 = time.monotonic()
            staged = learner.stage_traj(train_fx["traj"],
                                        train_fx["last_values"])
            torch.cuda.synchronize()
            res = {"stage_s": time.monotonic() - t0,
                   "bucket": [staged.n_nodes, staged.n_edges],
                   "rows": staged.t_len * staged.lanes}
            state = learner.init_state(gpu_params)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            snapshots, update_s, errs = [], [], []
            for ref in fx["steps"]:
                t0 = time.monotonic()
                state, metrics = learner.train_step(state, staged)
                torch.cuda.synchronize()
                update_s.append(time.monotonic() - t0)
                snapshots.append(({k: v.clone() for k, v in
                                   state.state_dict().items()},
                                  {k: float(v) for k, v in metrics.items()}))
            launches[algo] = kernels.launch_counts()
            res["update_s"] = update_s
            res["launches_per_3_updates"] = {
                k: v for k, v in launches[algo].items() if v}
            # the second run, with V-trace's (or the returns') check before
            # each update; bit-equal to the first
            state = learner.init_state(gpu_params)
            excluded = []
            for step, (ref, (snap, met)) in enumerate(
                    zip(fx["steps"], snapshots), start=1):
                if algo == "impala":
                    _, _, scan = learner.loss_and_grads(state, staged)
                    scan_err = {}
                    for got, key in zip(scan, ("target_logp", "vs",
                                               "pg_adv")):
                        diff = float(np.abs(got.cpu().numpy()
                                            - ref[key]).max())
                        scan_err[key] = diff
                        require(diff <= TOL * float(np.abs(ref[key]).max()),
                                f"IMPALA update {step}: {key} off JAX's by "
                                f"{diff}")
                    rho_jax = np.exp(ref["target_logp"][:-1] - behavior)
                    rho = np.exp(scan[0].cpu().numpy()[:-1] - behavior)
                    decided = np.abs(rho_jax - 1.0) > 1e-5
                    require(np.array_equal((rho > 1.0)[decided],
                                           (rho_jax > 1.0)[decided]),
                            f"IMPALA update {step}: a decided rho fell on "
                            f"the other side of the clip")
                    excluded.append(int((~decided).sum()))
                else:
                    _, _, returns = learner.loss_and_grads(state, staged)
                    scan_err = {"returns": float(np.abs(
                        returns.cpu().numpy() - fx["returns"]).max())}
                    require(scan_err["returns"] <= TOL * float(
                        np.abs(fx["returns"]).max()),
                        "PG returns off JAX's")
                state, _ = learner.train_step(state, staged)
                require(all(torch.equal(v, snap[k]) for k, v in
                            state.state_dict().items()),
                        f"{algo} update {step}: two runs differ")
                tree = params_to_flax(snap)
                rel = max(float(np.abs(tree[k] - ref["params"][k]).max()
                                / np.abs(ref["params"][k]).max())
                          for k in tree)
                require(rel <= TOL, f"{algo} update {step}: params off the "
                                    f"recorded JAX ones by {rel} of a "
                                    f"leaf's largest")
                require(sorted(met) == sorted(ref["metrics"]),
                        f"{algo} metric keys differ from JAX's")
                metric_err = {}
                for key, value in met.items():
                    want = ref["metrics"][key]
                    metric_err[key] = abs(value - want)
                    if key == "clip_rho_fraction":
                        bound = (excluded[0] / behavior.size if step == 1
                                 else 0.0)
                        require(metric_err[key] <= bound,
                                f"IMPALA update {step}: clip_rho_fraction "
                                f"{value} vs JAX's {want}")
                        continue
                    require(metric_err[key] <= TOL * max(1.0, abs(want)),
                            f"{algo} update {step}: metric {key} off JAX's "
                            f"by {metric_err[key]}")
                errs.append({"params_max_rel_err": rel,
                             "params_max_abs_err": max(
                                 float(np.abs(tree[k]
                                              - ref["params"][k]).max())
                                 for k in tree),
                             "metrics_abs_err": metric_err,
                             "scan_max_abs_err": scan_err,
                             "metrics": met})
            res["steps"] = errs
            if algo == "impala":
                res["clip_rho_rows_excluded"] = excluded
            scan = "vtrace" if algo == "impala" else "reward_to_go"
            for name in (scan, "ac_loss", "ln_linear_act",
                         "ln_linear_act_bwd", "csr_segment_mean_bwd",
                         "csr_segment_sum", "masked_mean_pool_concat_bwd"):
                require(launches[algo][name] > 0,
                        f"the {algo} update did not launch {name}")
            require(launches[algo]["ac_loss"] == len(fx["steps"]),
                    "K12 is not one launch per update")
            res["profiled"] = profile_update(learner, staged,
                                             learner.init_state(gpu_params))
            out[algo] = res
    emit("ac_train", **out)
    return launches


def profile_update(learner, staged, state, n_updates: int = 3):
    """``n_updates`` warmed updates under torch.profiler: device time over
    wall time (the profiler's own host cost is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    learner.train_step(state, staged)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_updates):
            learner.train_step(state, staged)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    device_ms_total = sum(e.device_time_total for e in prof.events()
                          if e.device_type == DeviceType.CUDA) / 1e3
    return {"updates": n_updates, "wall_ms": wall_ms,
            "device_ms": device_ms_total,
            "device_busy_share": device_ms_total / wall_ms}


def phase_ac_loop(card):
    """Phase 11, the slice's main path: ``python -m ddls_tpu_torch.train``
    (in this process) from the shipped export, 2 epochs of the IMPALA
    config (32 envs x 15 steps, impala.yaml's update) and 2 of the PG config
    (8 envs x 25 steps), each with a checkpoint; the launch counters reset
    just before each and read just after (K1–K6, K9, the algo's scan and K12
    must have run); each run twice from one seed, bit-equal."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for algo, path in (("impala", IMPALA_CONFIG_PATH),
                           ("pg", PG_CONFIG_PATH)):
            cfg_path = os.path.join(tmp, f"{algo}.json")
            with open(cfg_path, "w") as fh:
                json.dump(_earlier_slice(load_train_config(path)), fh)
            runs = []
            for attempt in range(2):
                ckpt_dir = os.path.join(tmp, f"{algo}{attempt}")
                argv = ["--config", cfg_path, "--epochs", "2", "--device",
                        "cuda", "--init-export", EXPORT_PATH,
                        "--checkpoint-dir", ckpt_dir]
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.monotonic()
                lines = _run_train_cli(argv)
                wall = time.monotonic() - t0
                if attempt == 0:
                    launches[algo] = kernels.launch_counts()
                state = torch.load(os.path.join(lines[-1]["checkpoint"],
                                                "train_state.pt"),
                                   weights_only=True)
                runs.append((lines, state, wall))
            (lines0, state0, wall0), (lines1, state1, _) = runs
            require([_deterministic(x) for x in lines0]
                    == [_deterministic(x) for x in lines1],
                    f"two {algo} runs from one seed printed different "
                    f"results")
            require(sorted(state0) == sorted(state1)
                    and "kl_coeff" not in state0
                    and all(torch.equal(a, b) for key in ("params", "mu",
                                                          "nu")
                            for a, b in zip(state0[key], state1[key]))
                    and state0["step"] == state1["step"] == 2,
                    f"two {algo} runs from one seed saved different states")
            scan = "vtrace" if algo == "impala" else "reward_to_go"
            for name in (*KERNEL_SITES, "mask_sample_logp",
                         "ln_linear_act_bwd",
                         "csr_segment_mean_bwd", "csr_segment_sum",
                         "masked_mean_pool_concat_bwd", scan, "ac_loss"):
                require(launches[algo][name] > 0,
                        f"kernel {name} was not launched by the {algo} loop")
            require(launches[algo]["ac_loss"] == 2,
                    f"the {algo} loop did not take one K12 launch per epoch")
            epochs = lines0[:-1]
            for line in epochs:
                require(all(np.isfinite(v) for v in line["learner"].values()),
                        f"non-finite {algo} learner metrics")
            emit("ac_loop", algo=algo, card=card, wall_s=wall0,
                 epochs=len(epochs),
                 env_steps_per_epoch=epochs[0]["env_steps_this_iter"],
                 epoch_s=[x["epoch_time"] for x in epochs],
                 env_steps_per_s=[x["env_steps_this_iter"] / x["epoch_time"]
                                  for x in epochs],
                 timing=[x["timing"] for x in epochs],
                 learner=[x["learner"] for x in epochs],
                 launches={k: v for k, v in launches[algo].items() if v})
    return {name: launches["impala"][name] + launches["pg"][name]
            for name in launches["impala"]}


# ------------------------------- K13–K16: the Ape-X DQN and ES kernels
def k13_parts(args, kwargs):
    logits, values, mask, eps, u_explore, u_pick, dueling = args
    rows, a = logits.shape

    def composition():
        q = (values[:, None] + logits - logits.mean(1, keepdim=True)
             if dueling else logits)
        greedy = q.masked_fill(mask == 0, policy_mod.FLOAT32_MIN).argmax(1)
        drawn = (torch.log(mask.float() + 1e-30)
                 - torch.log(-torch.log(u_pick))).argmax(1)
        return torch.where(u_explore < eps, drawn, greedy)

    # six inputs read once ([B, A] logits, mask, uniforms; [B] values,
    # epsilons, uniforms), the [B] actions written once; ~12 operations
    # per entry (the mean, the dueling sum, the mask, two logs, two
    # argmaxes)
    work = bound_ms(_nbytes(logits, values, mask, eps, u_explore, u_pick)
                    + rows * 4, 12 * rows * a)
    return (lambda: dqn_mod.dqn_act_plain(*args), composition, work,
            f"rows={rows} actions={a} dueling={dueling}")


def k14_parts(args, kwargs):
    (logits, values, next_logits, next_values, tgt_logits, tgt_values,
     next_mask, actions, rewards, discounts, weights, double_q,
     dueling) = args
    n, a = logits.shape

    def composition():
        def duel(lg, v):
            return v[:, None] + lg - lg.mean(1, keepdim=True) if dueling \
                else lg
        q, q_t = duel(logits, values), duel(tgt_logits, tgt_values)
        src = duel(next_logits, next_values) if double_q else q_t
        best = src.masked_fill(next_mask == 0,
                               policy_mod.FLOAT32_MIN).argmax(1)
        td = (q.gather(1, actions.long()[:, None])[:, 0]
              - (rewards + discounts * q_t.gather(1, best[:, None])[:, 0]))
        loss = torch.mean(weights * torch.nn.functional.huber_loss(
            td, torch.zeros_like(td), reduction="none"))
        g = weights * td.clamp(-1.0, 1.0) / n
        onehot = torch.nn.functional.one_hot(actions.long(), a).float()
        dlogits = g[:, None] * (onehot - 1.0 / a) if dueling \
            else g[:, None] * onehot
        return loss, td.abs(), dlogits, g

    forwards = 3 if double_q else 2
    # the forwards' heads, the mask and the four per-row inputs read once;
    # the gradient, |td|, the metrics and the loss written once; ~15
    # operations per entry of each forward
    nbytes = (forwards * n * (a + 1) * 4 + _nbytes(next_mask, actions,
                                                   rewards, discounts,
                                                   weights)
              + n * (a + 2) * 4 + 5 * 4)
    return (lambda: dqn_mod.dqn_td_loss_grad_plain(*args), composition,
            bound_ms(nbytes, 15 * forwards * n * a),
            f"rows={n} actions={a} double_q={double_q} dueling={dueling}")


def k15_parts(args, kwargs):
    fitness, eps, theta, sigma, l2 = args
    p, n = fitness.shape[0], theta.shape[0]

    def composition():
        ranks = torch.argsort(torch.argsort(fitness, stable=True),
                              stable=True).float()
        w = ranks / max(p - 1, 1) - 0.5
        g = -torch.matmul(w[:p // 2] - w[p // 2:], eps) / (p * sigma) \
            + l2 * theta
        return g, torch.linalg.vector_norm(g)

    # the fitness, the noise and the params read once, the gradient,
    # the ranks and the metrics written once; the weighted sum is P
    # operations per parameter, the ranks P^2 comparisons
    work = bound_ms(_nbytes(fitness, eps, theta) + (n + p + 4) * 4,
                    (p + 3) * n + p * p)
    return (lambda: es_mod.es_update_plain(*args), composition, work,
            f"population={p} params={n}")


def k16_parts(args, kwargs):
    logits, mask, noise, std = args
    rows, a = logits.shape

    def composition():
        return (logits.masked_fill(mask == 0, policy_mod.FLOAT32_MIN)
                + std * noise).argmax(1)

    work = bound_ms(_nbytes(logits, mask, noise) + rows * 4, 5 * rows * a)
    return (lambda: es_mod.es_act_plain(*args), composition, work,
            f"members={rows} actions={a}")


# (module whose global the learner calls, attribute, parts function)
DQN_ES_SITES = {
    "dqn_act": (dqn_mod, "dqn_act", k13_parts),
    "dqn_td_loss": (dqn_mod, "_dqn_td_loss_cuda", k14_parts),
    "es_update": (es_mod, "es_update", k15_parts),
    "es_act": (es_mod, "es_act", k16_parts),
}


def dqn_learner(dqn_fx):
    """(learner, its state at the recorded JAX initialisation) on the card."""
    model = policy_mod.GNNPolicy(**dqn_fx["arch"])
    learner = dqn_mod.ApexDQNLearner(model, dqn_fx["cfg"], device="cuda")
    return learner, learner.init_state(
        {k: v.cuda() for k, v in params_from_flax(dqn_fx["init"],
                                                  model).items()})


def es_noise(learner, model, eps_tree):
    """The recorded per-leaf noise [P/2, ...] as the learner's flat [P/2, n]
    on the card."""
    half = next(iter(eps_tree.values())).shape[0]
    return torch.stack([learner.flat(params_from_flax(
        {k: v[i] for k, v in eps_tree.items()}, model))
        for i in range(half)]).cuda()


def dqn_act_edge_cases(args):
    """K13's recorded call (8 envs) and what it cannot give: a fully masked
    row, a one-valid-action row and an exact tie of Q (the lower index must
    win), each greedy; the same rows exploring; dueling off; and the loop's
    shape (32 envs, tiled, per_worker_epsilons at 400,000 steps)."""
    logits, values, mask, eps, u_explore, u_pick, dueling = args
    a = logits.shape[1]
    ext = [x[:3].clone() for x in (logits, values, mask, eps, u_explore,
                                   u_pick)]
    ext[2][0] = 0
    ext[2][1] = 0
    ext[2][1, a - 2] = 1
    ext[0][2] = 0.75
    ext[2][2] = 1
    ext[3][:] = 0.5
    ext[4][:] = 0.9
    greedy = tuple(torch.cat([x, e]) for x, e in zip(args[:6], ext))
    explore = list(greedy)
    explore[4] = torch.zeros_like(greedy[4])
    tiled = [x.repeat((4,) + (1,) * (x.dim() - 1)) for x in args[:6]]
    tiled[3] = torch.as_tensor(dqn_mod.per_worker_epsilons(
        32, 400_000, dqn_mod.DQNConfig()), device="cuda")
    return ([(*greedy, dueling), (*explore, dueling), (*greedy, False)],
            (*tiled, dueling))


def dqn_td_edge_cases(args):
    """K14's recorded call (512 replay rows) with rows the replay cannot
    give: next row 0 fully masked, next row 1 one valid action, row 2 no
    bootstrap; rows 3-5 with zero logits, value 0.25 and rewards that make
    td exactly -0.5, -1 and 2 (|td| below, at and above the Huber kink);
    under dueling and double-Q, and with either off."""
    cases = []
    for double_q, dueling in ((True, True), (False, True), (True, False),
                              (False, False)):
        case = [x.clone() if torch.is_tensor(x) else x for x in args]
        logits, values, next_mask, rewards, discounts = (
            case[0], case[1], case[6], case[8], case[9])
        next_mask[0] = 0
        next_mask[1] = 0
        next_mask[1, logits.shape[1] // 2] = 1
        discounts[2] = 0.0
        for row, td in ((3, -0.5), (4, -1.0), (5, 2.0)):
            logits[row] = 0.0
            values[row] = 0.25
            discounts[row] = 0.0
            rewards[row] = (0.25 if dueling else 0.0) - td
        case[11], case[12] = double_q, dueling
        cases.append(tuple(case))
    return cases


def es_update_edge_cases(args):
    """K15's recorded call (P = 10) with fitness it cannot give: ties,
    every member equal, a NaN; and a population of 2."""
    fitness, eps, theta, sigma, l2 = args
    f = fitness.clone()
    cases = []
    for values in ([3.0, 1.0, 3.0, 2.0, 1.0, 1.0, 0.5, 3.0, 2.5, 4.0],
                   [2.0] * 10, [1.0, float("nan"), 3.0, 0.0, -0.0, 2.0,
                                2.0, 5.0, float("nan"), 1.0]):
        cases.append((torch.tensor(values, device=f.device), eps, theta,
                      sigma, l2))
    cases.append((torch.tensor([1.0, 1.0], device=f.device), eps[:1],
                  theta, sigma, l2))
    cases.append((torch.tensor([2.0, 1.0], device=f.device),
                  eps[:1].contiguous(), theta, sigma, l2))
    return cases


def es_act_edge_cases(args):
    """K16's recorded call (10 members) with a fully masked member (index 0
    must win), a one-valid-action member, and an exact tie at zero noise
    (the lower index must win)."""
    logits, mask, noise, std = args
    a = logits.shape[1]
    lg, mk, nz = logits.clone(), mask.clone(), noise.clone()
    mk[0] = 0
    mk[1] = 0
    mk[1, a - 1] = 1
    lg[2] = -3.0
    lg[2, 4] = lg[2, 9] = 2.0
    mk[2] = 1
    return [(lg, mk, nz, std), (lg, mk, torch.zeros_like(nz), 0.0),
            (lg, mk, nz, 100.0)]


def _same_bits(x, y) -> bool:
    """Bit-equal tensors (a NaN equals a NaN of the same bits)."""
    if x.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        x, y = (t.view(ints[t.element_size()]) for t in (x, y))
    return torch.equal(x, y)


def k15_compare(out, ref):
    """K15 against its plain version: the centred ranks exactly, the
    gradient within 1e-5 of its largest magnitude, the metrics likewise
    (a NaN fitness makes the mean, max and std NaN in both)."""
    require(torch.equal(out[2], ref[2]), "es_update's centred ranks differ "
                                         "from the plain version's")
    nan = torch.isnan(ref[1])
    require(torch.equal(torch.isnan(out[1]), nan),
            "es_update's NaN metrics differ from the plain version's")
    return ((out[0], torch.where(nan, 0.0, out[1])),
            (ref[0], torch.where(nan, 0.0, ref[1])))


def check_dqn_es_kernels(dqn_es_fx, train_fx, params):
    """Phase 3, K13–K16: each kernel's call in one step of its learner on
    the recorded fixtures (K13: DQN acting on recorded step 0, 8 envs; K14:
    the first recorded DQN update, 512 rows; K15: the first recorded ES
    update, P = 10 over the shipped policy's parameters; K16: the first
    step of the recorded ES window) and the edge cases they cannot give;
    each held against its plain version (K13, K16 and K15's ranks exactly;
    every float within 1e-5 of its largest magnitude), bitwise across two
    runs, and timed at the main path's shapes (K13 at the loop's 32 envs),
    with a PyTorch composition of the same function beside it."""
    dqn_fx, es_fx = dqn_es_fx["dqn"], dqn_es_fx["es"]
    calls = {}
    learner, state = dqn_learner(dqn_fx)
    obs = {k: v[0] for k, v in train_fx["traj"]["obs"].items()}
    calls.update(record_sites({"dqn_act": DQN_ES_SITES["dqn_act"]},
                              lambda: learner.eps_greedy_actions(
                                  obs, dqn_fx["act"]["eps"][1],
                                  torch.as_tensor(dqn_fx["act"][
                                      "u_explore"][1, 0], device="cuda"),
                                  torch.as_tensor(dqn_fx["act"][
                                      "u_pick"][1, 0], device="cuda"))))
    replay = fixture_replay(dqn_fx["cfg"])
    ref = dqn_fx["updates"][0]
    staged = learner.stage_batch(dqn_mod.train_batch(
        replay.gather(ref["idx"]), ref["weights"]))
    with torch.enable_grad():
        calls.update(record_sites(
            {"dqn_td_loss": DQN_ES_SITES["dqn_td_loss"]},
            lambda: learner.loss_and_grads(state, staged)))
    model, _, _ = load_export(EXPORT_PATH)
    es_learner = es_mod.ESLearner(model, es_fx["cfg"], 10, device="cuda")
    es_state = es_learner.init_state({k: v.cuda() for k, v in
                                      params.items()})
    eps = es_noise(es_learner, model, es_fx["window"]["eps"])
    stacked = es_learner.stack(es_learner.flat(es_state.params), eps)
    env_cfg = load_train_config()["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(env_cfg)) for _ in range(10)],
        seeds=list(range(10)))
    vec.reset()
    noise = torch.as_tensor(es_fx["window"]["noise"][0], device="cuda")
    calls.update(record_sites({"es_act": DQN_ES_SITES["es_act"]},
                              lambda: es_learner.pop_actions(
                                  stacked, stack_obs(vec.obs), noise,
                                  es_fx["cfg"].action_noise_std)))
    calls.update(record_sites({"es_update": DQN_ES_SITES["es_update"]},
                              lambda: es_learner.update(
                                  es_state, eps, es_fx["window"][
                                      "fitness"])))
    results = {}
    for name, (_, _, parts) in DQN_ES_SITES.items():
        require(len(calls[name]) == 1,
                f"one learner step made {len(calls[name])} {name} calls")
        fn, args, _ = calls[name][0]
        if name == "dqn_act":
            edge, timed_args = dqn_act_edge_cases(args)
        elif name == "dqn_td_loss":
            edge, timed_args = dqn_td_edge_cases(args), args
        elif name == "es_update":
            edge, timed_args = es_update_edge_cases(args), args
        else:
            edge, timed_args = es_act_edge_cases(args), args
        res = {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None,
               "library_device_ms": None, "calls_per_step": 1}
        for case in [args, *edge, timed_args]:
            plain, _, _, _ = parts(case, {})
            out, again, ref_out = fn(*case), fn(*case), plain()
            torch.cuda.synchronize()
            require(all(_same_bits(x, y) for x, y in
                        zip(_flat(out), _flat(again))),
                    f"{name} is not bitwise repeatable")
            if name == "es_update":
                err, rel = max_err_scaled(*k15_compare(out, ref_out))
            else:
                err, rel = max_err_scaled(out, ref_out)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["max_rel_err"] = max(res["max_rel_err"], rel)
        if name == "dqn_act":
            out = fn(*edge[0]).cpu().numpy()
            n = args[0].shape[0]
            require(out[n] == 0 and out[n + 1] == args[0].shape[1] - 2
                    and out[n + 2] == 0, "K13's greedy edge rows: a fully "
                                         "masked row, one valid action, a tie")
        if name == "dqn_td_loss":
            td = fn(*edge[0])[2].cpu().numpy()
            require(td[3:6].tolist() == [0.5, 1.0, 2.0],
                    f"K14's pinned |td| rows gave {td[3:6]}")
        if name == "es_act":
            out = fn(*edge[0]).cpu().numpy()
            tie = fn(*edge[1]).cpu().numpy()
            require(out[0] == 0 and out[1] == args[0].shape[1] - 1
                    and tie[2] == 4, "K16's edge members: fully masked, "
                                     "one valid action, a tie")
        plain, composition, (bound, bound_by), shape = parts(timed_args, {})
        res.update(shape=shape, bound_ms=bound, bound_by=bound_by,
                   ms=device_ms(lambda: fn(*timed_args)),
                   eager_ms=eager_ms(lambda: fn(*timed_args)),
                   plain_ms=eager_ms(plain, iters=20),
                   composition_ms=eager_ms(composition),
                   composition_device_ms=device_ms(composition))
        results[name] = res
    return results


# ----------------------------------------- the Ape-X DQN and ES phases
def profile_calls(fn, n_calls: int = 3):
    """``n_calls`` warmed calls of ``fn`` under torch.profiler: device time
    over wall time (the profiler's own host cost is inside the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n_calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    device_ms_total = sum(e.device_time_total for e in prof.events()
                          if e.device_type == DeviceType.CUDA) / 1e3
    return {"calls": n_calls, "wall_ms": wall_ms,
            "device_ms": device_ms_total,
            "device_busy_share": device_ms_total / wall_ms}


def _leaf_rel(state, key, ref):
    tree = params_to_flax(dict(zip(state.names, [
        x.detach() for x in getattr(state, key)])))
    return max(float(np.abs(tree[k] - ref[k]).max()
                     / max(np.abs(ref[k]).max(), 1e-30)) for k in ref)


def phase_dqn_train(dqn_es_fx, train_fx, card):
    """Phase 12: the recorded JAX Ape-X DQN on the card. K13 on the recorded
    trajectory's observations (64 steps x 8 envs) with the recorded
    epsilons and uniforms at 3 schedule points: every action JAX's. Then
    the 3 recorded updates on the same replay rows and importance weights
    (the port's own replay buffer holds the same 488 n-step transitions):
    the first gradient, and params, target params and adam's moments after
    each update within 1e-5 of each leaf's largest magnitude, the target
    bit-equal to the params right after the update-2 sync, metrics within
    1e-5 of max(1, |JAX|), |td| within 1e-5 of its largest; the port's own
    priorities against the recorded ones (reported: they differ at float32
    rounding, so the port's own draw could pick other rows). Launch
    counters reset before the acting and read after the updates (K1-K3,
    K5, K6, K13, K14 must have run; the DQN path launches no K4: its
    Q-network is unmasked and K13 does the masking). A second run of the
    updates bit-equal; seconds per update and the device busy share of 3
    updates under torch.profiler."""
    dqn_fx = dqn_es_fx["dqn"]
    obs, act = train_fx["traj"]["obs"], dqn_fx["act"]
    learner, state = dqn_learner(dqn_fx)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    mismatches = 0
    for k in range(len(act["env_steps"])):
        for t in range(obs["action_mask"].shape[0]):
            got = learner.eps_greedy_actions(
                {key: v[t] for key, v in obs.items()}, act["eps"][k],
                torch.as_tensor(act["u_explore"][k, t], device="cuda"),
                torch.as_tensor(act["u_pick"][k, t], device="cuda"))
            mismatches += int((got != act["actions"][k, t]).sum())
    act_s = time.monotonic() - t0
    require(mismatches == 0, f"K13 acting differs from JAX's on "
                             f"{mismatches} decisions")
    replay = fixture_replay(dqn_fx["cfg"])
    base = (replay.priorities.copy(), replay.max_priority)
    batches = [dqn_mod.train_batch(replay.gather(ref["idx"]),
                                   ref["weights"])
               for ref in dqn_fx["updates"]]
    runs, errs, update_s = [], [], []
    launches = None
    for attempt in range(2):
        if attempt:
            learner, state = dqn_learner(dqn_fx)
        replay.priorities[:], replay.max_priority = base[0].copy(), base[1]
        snaps = []
        for step, (ref, batch) in enumerate(zip(dqn_fx["updates"], batches),
                                            start=1):
            if step == 1 and attempt == 0:
                with torch.enable_grad():
                    _, _, grads = learner.loss_and_grads(
                        state, learner.stage_batch(batch))
                tree = params_to_flax(dict(zip(state.names, grads)))
                grad_rel = max(float(np.abs(tree[k] - ref["grads"][k]).max()
                                     / np.abs(ref["grads"][k]).max())
                               for k in tree)
                require(grad_rel <= TOL, f"DQN first gradient off JAX's by "
                                         f"{grad_rel} of a leaf's largest")
            torch.cuda.synchronize()
            t1 = time.monotonic()
            state, metrics, td = learner.train_step(state, batch)
            torch.cuda.synchronize()
            if attempt == 0:
                update_s.append(time.monotonic() - t1)
            replay.update_priorities(ref["idx"], td)
            snaps.append(([x.detach().clone() for key in (
                "params", "target_params", "mu", "nu")
                for x in getattr(state, key)], metrics, td,
                replay.priorities[:replay.size].copy()))
            if attempt:
                continue
            err = {key: _leaf_rel(state, key, ref[key]) for key in
                   ("params", "target_params", "mu", "nu")}
            for key, value in err.items():
                require(value <= TOL, f"DQN update {step}: {key} off JAX's "
                                      f"by {value} of a leaf's largest")
            synced = all(torch.equal(a, b) for a, b in
                         zip(state.target_params, state.params))
            require(synced == (step == 2), f"DQN update {step}: target "
                                           f"sync {synced}")
            metric_err = {}
            for key, want in ref["metrics"].items():
                metric_err[key] = abs(metrics[key] - want)
                require(metric_err[key] <= TOL * max(1.0, abs(want)),
                        f"DQN update {step}: {key} off JAX's by "
                        f"{metric_err[key]}")
            td_err = float(np.abs(td - ref["td_abs"]).max())
            require(td_err <= TOL * float(np.abs(ref["td_abs"]).max()),
                    f"DQN update {step}: |td| off JAX's by {td_err}")
            errs.append({**{f"{k}_max_rel_err": v for k, v in err.items()},
                         "metrics_abs_err": metric_err,
                         "td_abs_max_abs_err": td_err,
                         "priorities_max_rel_err": float(np.max(
                             np.abs(replay.priorities[:replay.size]
                                    - ref["priorities"])
                             / ref["priorities"])),
                         "metrics": metrics})
        if attempt == 0:
            launches = kernels.launch_counts()
        runs.append(snaps)
    for (s0, m0, t0_, p0), (s1, m1, t1_, p1) in zip(*runs):
        require(all(torch.equal(a, b) for a, b in zip(s0, s1))
                and m0 == m1 and np.array_equal(t0_, t1_)
                and np.array_equal(p0, p1), "two DQN runs differ")
    for name in ("ln_linear_act", "csr_segment_mean",
                 "masked_mean_pool_concat", "ln_linear_act_bwd",
                 "csr_segment_mean_bwd",
                 "csr_segment_sum", "masked_mean_pool_concat_bwd",
                 "dqn_act", "dqn_td_loss"):
        require(launches[name] > 0, f"the DQN acting and updates did not "
                                    f"launch {name}")
    # one K14 launch per update, and one for the first-gradient check
    require(launches["dqn_td_loss"] == 4, "K14 is not one launch per update")
    require(launches["mask_logits_argmax"] == 0, "the DQN path launched K4")
    profiled = profile_calls(lambda: learner.train_step(state, batches[2]))
    emit("dqn_train", card=card, act_decisions=int(act["actions"].size),
         act_s=act_s, first_grad_max_rel_err=grad_rel, steps=errs,
         update_s=update_s, rows=int(dqn_fx["cfg"].train_batch_size),
         profiled=profiled,
         launches={k: v for k, v in launches.items() if v})
    return launches


def phase_es_train(dqn_es_fx, params, card):
    """Phase 13: the recorded JAX ES on the card. The recorded 32-step
    window: 10 of the port's env_load32_price_mixed envs (seeded 0-9), the
    shipped params perturbed by the recorded noise, the recorded action
    noise: every action JAX's and the fitness bit-equal. Then the 3
    recorded updates: params and adam's moments within 1e-6 of each leaf's
    largest magnitude, metrics within 1e-6 of max(1, |JAX|); a second run
    of the updates bit-equal; launch counters around the window (K1-K3,
    K16) and the updates (K15); seconds per update."""
    es_fx = dqn_es_fx["es"]
    model, _, _ = load_export(EXPORT_PATH)
    gpu_params = {k: v.cuda() for k, v in params.items()}
    learner = es_mod.ESLearner(model, es_fx["cfg"], 10, device="cuda")
    state = learner.init_state(gpu_params)
    stacked = learner.stack(learner.flat(state.params),
                            es_noise(learner, model, es_fx["window"]["eps"]))
    env_cfg = load_train_config()["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(env_cfg)) for _ in range(10)], seeds=list(range(10)))
    vec.reset()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    fitness = np.zeros(10)
    act_s = 0.0
    for t, noise in enumerate(es_fx["window"]["noise"]):
        t1 = time.monotonic()
        actions = learner.pop_actions(stacked, stack_obs(vec.obs),
                                      torch.as_tensor(noise, device="cuda"),
                                      es_fx["cfg"].action_noise_std)
        act_s += time.monotonic() - t1
        require(np.array_equal(actions, es_fx["window"]["actions"][t]),
                f"ES window step {t}: actions differ from JAX's")
        _, rewards, _ = vec.step(actions)
        fitness += rewards
    window_s = time.monotonic() - t0
    window_launches = kernels.launch_counts()
    require(np.array_equal(fitness, es_fx["window"]["fitness"]),
            "the ES window's fitness differs from JAX's")
    require(window_launches["es_act"] == len(es_fx["window"]["noise"]),
            "K16 is not one launch per window step")
    for name in ("ln_linear_act", "csr_segment_mean",
                 "masked_mean_pool_concat"):
        require(window_launches[name] > 0, f"the ES window did not launch "
                                           f"{name}")
    eps = [es_noise(learner, model, ref["eps"]) for ref in es_fx["updates"]]
    runs, errs, update_s = [], [], []
    for attempt in range(2):
        state = learner.init_state(gpu_params)
        kernels.reset_launch_counts()
        snaps = []
        for step, (ref, e) in enumerate(zip(es_fx["updates"], eps), start=1):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            state, metrics = learner.update(state, e, ref["fitness"])
            if attempt == 0:
                update_s.append(time.monotonic() - t1)
            snaps.append(([x.detach().clone() for key in ("params", "mu",
                                                          "nu")
                           for x in getattr(state, key)], metrics))
            if attempt:
                continue
            err = {key: _leaf_rel(state, key, ref[key])
                   for key in ("params", "mu", "nu")}
            for key, value in err.items():
                require(value <= ES_UPDATE_TOL,
                        f"ES update {step}: {key} off JAX's by {value} of a "
                        f"leaf's largest")
            metric_err = {}
            for key, want in ref["metrics"].items():
                metric_err[key] = abs(metrics[key] - want)
                require(metric_err[key]
                        <= ES_UPDATE_TOL * max(1.0, abs(want)),
                        f"ES update {step}: {key} off JAX's by "
                        f"{metric_err[key]}")
            errs.append({**{f"{k}_max_rel_err": v for k, v in err.items()},
                         "metrics_abs_err": metric_err, "metrics": metrics})
        update_launches = kernels.launch_counts()
        require(update_launches["es_update"] == 3,
                "K15 is not one launch per update")
        runs.append(snaps)
    for (s0, m0), (s1, m1) in zip(*runs):
        require(all(torch.equal(a, b) for a, b in zip(s0, s1)) and m0 == m1,
                "two ES runs differ")
    emit("es_train", card=card, window_steps=len(es_fx["window"]["noise"]),
         window_s=window_s, act_ms_per_step=act_s / len(
             es_fx["window"]["noise"]) * 1e3,
         fitness=fitness.tolist(), steps=errs, update_s=update_s,
         launches_window={k: v for k, v in window_launches.items() if v},
         launches_updates={k: v for k, v in update_launches.items() if v})
    return {name: window_launches[name] + update_launches[name]
            for name in window_launches}


def phase_dqn_es_loop(card):
    """Phase 14, the slice's main path: ``python -m ddls_tpu_torch.train``
    (in this process) with the apex_dqn config (32 envs x 16 steps, 3
    epochs, learning_starts cut to 512 so that epochs 2 and 3 update; from
    flax's initialisation) and with the es config (a population of 10, 2
    epochs, rollout_length cut to 25; from the shipped export), each with
    one greedy evaluation episode and a checkpoint; the launch counters
    reset just before each run and read just after (DQN: K1-K3, K5, K6,
    K13, K14; ES: K1-K4, K15, K16, K4 in the greedy evaluation); each run
    twice from one seed, bit-equal."""
    import tempfile

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for algo, path in (("apex_dqn", DQN_CONFIG_PATH),
                           ("es", ES_CONFIG_PATH)):
            cfg = _earlier_slice(load_train_config(path))
            if algo == "apex_dqn":
                cfg["algo"]["algo_config"]["replay_buffer_config"][
                    "learning_starts"] = 512
                epochs, init = "3", []
            else:
                cfg["epoch_loop"]["rollout_length"] = 25
                epochs, init = "2", ["--init-export", EXPORT_PATH]
            cfg_path = os.path.join(tmp, f"{algo}.json")
            with open(cfg_path, "w") as fh:
                json.dump(cfg, fh)
            runs = []
            for attempt in range(2):
                argv = ["--config", cfg_path, "--epochs", epochs,
                        "--device", "cuda", *init, "--checkpoint-dir",
                        os.path.join(tmp, f"{algo}{attempt}"),
                        "--eval-episodes", "1", "--eval-seed", "1799"]
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.monotonic()
                lines = _run_train_cli(argv)
                wall = time.monotonic() - t0
                if attempt == 0:
                    launches[algo] = kernels.launch_counts()
                state = torch.load(os.path.join(lines[-1]["checkpoint"],
                                                "train_state.pt"),
                                   weights_only=True)
                runs.append((lines, state, wall))
            (lines0, state0, wall0), (lines1, state1, _) = runs
            require([_deterministic(x) for x in lines0]
                    == [_deterministic(x) for x in lines1],
                    f"two {algo} runs from one seed printed different "
                    f"results")
            keys = ("params", "mu", "nu") + (
                ("target_params",) if algo == "apex_dqn" else ())
            require(sorted(state0) == sorted(state1)
                    and all(torch.equal(a, b) for key in keys
                            for a, b in zip(state0[key], state1[key]))
                    and state0["step"] == state1["step"],
                    f"two {algo} runs from one seed saved different states")
            used = (("dqn_act", "dqn_td_loss", "ln_linear_act_bwd",
                     "csr_segment_mean_bwd", "csr_segment_sum",
                     "masked_mean_pool_concat_bwd")
                    if algo == "apex_dqn" else
                    ("es_act", "es_update", "mask_logits_argmax"))
            for name in ("ln_linear_act", "csr_segment_mean",
                         "masked_mean_pool_concat", *used):
                require(launches[algo][name] > 0,
                        f"kernel {name} was not launched by the {algo} loop")
            epochs_out = lines0[:-1]
            if algo == "apex_dqn":
                require([x["learner"].get("num_updates", 0)
                         for x in epochs_out] == [0, 1, 1],
                        "the DQN loop's updates per epoch are not 0, 1, 1")
                require(launches[algo]["dqn_td_loss"] == 2,
                        "the DQN loop did not take one K14 launch per update")
                require(launches[algo]["mask_logits_argmax"] == 0,
                        "the DQN loop launched K4")
            else:
                require(launches[algo]["es_update"] == 2,
                        "the ES loop did not take one K15 launch per epoch")
            for line in epochs_out:
                require(all(np.isfinite(v) for v in line["learner"].values()),
                        f"non-finite {algo} learner metrics")
            emit("dqn_es_loop", algo=algo, card=card, wall_s=wall0,
                 epochs=len(epochs_out),
                 env_steps_per_epoch=epochs_out[0]["env_steps_this_iter"],
                 epoch_s=[x["epoch_time"] for x in epochs_out],
                 env_steps_per_s=[x["env_steps_this_iter"] / x["epoch_time"]
                                  for x in epochs_out],
                 timing=[x["timing"] for x in epochs_out],
                 learner=[x["learner"] for x in epochs_out],
                 evaluation=lines0[-1]["evaluation"],
                 launches={k: v for k, v in launches[algo].items() if v})
    return launches


# --------------------------- K18–K20: heads backward, optimiser, minibatch
def _new_result(**extra):
    return {"max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None,
            "library_device_ms": None, "calls_per_step": 1, **extra}


def _random_heads(hiddens, n_actions, seed):
    """Head layers of nn.Linear's layout on the card, seeded."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for final in (n_actions, 1):
        widths = [24, *hiddens, final]
        out.append([((torch.randn(widths[i + 1], widths[i], generator=g)
                      / widths[i] ** 0.5).cuda(),
                     (torch.randn(widths[i + 1], generator=g) * 0.1).cuda())
                    for i in range(len(widths) - 1)])
    return out


def check_heads_optim_kernels(params, fx):
    """Phase 3, K18–K20 on the training fixture's first minibatch step (128
    rows at the (38, 128) bucket, the shipped heads 24 -> 17 -> {17, 1}):
    K18 (the heads' backward, its block-order reduce inside its one
    launch) against autograd of the plain heads, also at 1,057 and 4,000
    rows (its ticket), on the Ape-X DQN's heads (24 -> 256 -> {17, 1} at
    512 rows), the default (256, 256) heads and one row; K19 (the global
    norm, the clip and the adam update in one launch) against the plain
    optimiser over five steps of the shipped policy's 36 leaves with the
    clip not firing, firing, and at a norm within rounding of the clip,
    and timed at 1, 4, 8 and 16 CTAs besides its plan's; K20 (the
    minibatch assembly) against its plain version and
    ``prepare_flat_batch``'s arrays on the minibatch, repeated samples, the
    Ape-X DQN's 512 rows, one sample and the full batch, exactly, its C
    entry's plan the Python mirror's. Every float within 1e-5 of each
    output's largest magnitude, every kernel bitwise across two runs, and
    timed at the minibatch step's shapes (K20 also at the DQN's 512
    rows)."""
    model, _, _ = load_export(EXPORT_PATH)
    cfg = fx["cfg"]
    learner = ppo_mod.PPOLearner(model, cfg, device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    n = staged.t_len * staged.lanes
    idx = torch.as_tensor(fx["runs"][1]["perms"][0][:cfg.sgd_minibatch_size],
                          device="cuda")
    results = {}

    # K20: the minibatch assembly
    rng = np.random.default_rng(0)
    res = _new_result()
    obs = fx["traj"]["obs"]
    rows = {k: np.swapaxes(np.asarray(v), 0, 1).reshape(
        (n,) + np.shape(v)[2:]) for k, v in obs.items()}
    # the Ape-X DQN's minibatch: 512 rows drawn with repeats
    dqn_idx = torch.as_tensor(rng.integers(0, n, 512), device="cuda")
    for case in (idx, torch.as_tensor(rng.integers(0, n, 128),
                                      device="cuda"),
                 dqn_idx, idx[:1].clone(), learner._positions(n)):
        out = policy_mod.minibatch_gather(staged.tensors, case,
                                           staged.n_nodes, staged.n_edges)
        again = policy_mod.minibatch_gather(staged.tensors, case,
                                             staged.n_nodes, staged.n_edges)
        plain = policy_mod.minibatch_gather_plain(
            staged.tensors, case, staged.n_nodes, staged.n_edges)
        sel = {k: v[case.cpu().numpy()] for k, v in rows.items()}
        sel["node_features"] = sel["node_features"][:, :staged.n_nodes]
        for key in ("edge_features", "edges_src", "edges_dst"):
            sel[key] = sel[key][:, :staged.n_edges]
        host = policy_mod.prepare_flat_batch(sel)
        torch.cuda.synchronize()
        require(sorted(out) == sorted(plain) == sorted(host),
                "K20's arrays differ from prepare_flat_batch's")
        for key in out:
            require(torch.equal(out[key], again[key])
                    and torch.equal(out[key], plain[key])
                    and np.array_equal(out[key].cpu().numpy(), host[key]),
                    f"K20's {key} differs from its plain version or "
                    f"prepare_flat_batch")
    sizes = (staged.n_nodes, staged.n_edges,
             staged["node_features"].shape[2],
             staged["edge_features"].shape[2],
             staged["graph_features"].shape[1],
             staged["action_mask"].shape[1])
    for m in (idx.shape[0], dqn_idx.shape[0], 1, n):
        # the C entry plans as models/policy.py's mirror does
        got = kernels.query("minibatch_gather", "ddls_minibatch_gather_plan",
                            m, *sizes)
        want = policy_mod.minibatch_gather_plan(m, *sizes)
        require(got == want.packed(), f"K20's plan {got} is not the "
                                      f"mirror's {want}")
    per_sample = sum(t[0].numel() * t.element_size() for t in (
        staged["node_features"], staged["edge_features"],
        staged["graph_features"], staged["action_mask"],
        staged["node_mask"], staged["structure"]))

    def timed_gather(rows):
        """K20's times and bound at the samples ``rows``."""
        m = rows.shape[0]
        out = policy_mod.minibatch_gather(staged.tensors, rows,
                                           staged.n_nodes, staged.n_edges)
        written = sum(t.numel() * t.element_size() for t in out.values())
        bound, bound_by = bound_ms(m * per_sample + _nbytes(rows) + written,
                                   0.0)

        def gather():
            return policy_mod.minibatch_gather(staged.tensors, rows,
                                                staged.n_nodes,
                                                staged.n_edges)

        def gather_plain():
            return policy_mod.minibatch_gather_plain(
                staged.tensors, rows, staged.n_nodes, staged.n_edges)

        plan = policy_mod.minibatch_gather_plan(m, *sizes)
        return dict(shape=f"samples={m} of {n} nodes={staged.n_nodes} "
                          f"edges={staged.n_edges}",
                    bound_ms=bound, bound_by=bound_by, ms=device_ms(gather),
                    eager_ms=eager_ms(gather),
                    plain_ms=eager_ms(gather_plain, iters=20),
                    plan=plan._asdict())

    res.update(timed_gather(idx))
    res["rows_512"] = timed_gather(dqn_idx)
    results["minibatch_gather"] = res

    # K18: the heads' backward, from the minibatch forward's pooled rows
    batch = learner.minibatch(staged, idx)
    calls = record_sites({"mlp_heads": (policy_mod, "mlp_heads",
                                        k17_parts)},
                         lambda: learner.model.flat_batched(batch))
    x, logit_layers, value_layers, activation = calls["mlp_heads"][0][1]
    g = torch.Generator().manual_seed(1)

    def grads_in(rows, a):
        return (torch.randn(rows, a, generator=g).cuda(),
                torch.randn(rows, generator=g).cuda())

    main_case = (x, logit_layers, value_layers, activation,
                 *grads_in(x.shape[0], logit_layers[-1][0].shape[0]))
    cases = [main_case]
    for hiddens, rows_n, seed in (((256,), 512, 2), ((256, 256), 128, 3),
                                  ((17,), 1, 4), ((17,), 1057, 5),
                                  ((17,), 4000, 6)):
        lh, vh = _random_heads(hiddens, 17, seed)
        cases.append((torch.randn(rows_n, 24, generator=g).cuda(), lh, vh,
                      "relu", *grads_in(rows_n, 17)))
    res = _new_result()
    for case in cases:
        out = policy_mod.mlp_heads_bwd(*case)
        again = policy_mod.mlp_heads_bwd(*case)
        ref = policy_mod.mlp_heads_bwd_plain(*case)
        torch.cuda.synchronize()
        outs, refs = [out[0], *out[1]], [ref[0], *ref[1]]
        require(all(torch.equal(a, b) for a, b in
                    zip(outs, [again[0], *again[1]])),
                "mlp_heads_bwd is not bitwise repeatable")
        err, rel = max_err_scaled(tuple(outs), tuple(refs))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["max_rel_err"] = max(res["max_rel_err"], rel)
    leaves = [t.detach().clone().requires_grad_() for t in
              [x] + [t for layer in logit_layers + value_layers
                     for t in layer]]
    pairs = list(zip(leaves[1::2], leaves[2::2]))
    n_l = len(logit_layers)

    def library_bwd():
        with torch.enable_grad():
            lo, va = _heads_composition(leaves[0], pairs[:n_l],
                                        pairs[n_l:], activation)
            return torch.autograd.grad((lo, va), leaves, main_case[4:])

    bound, bound_by = _heads_work(x, logit_layers, value_layers,
                                  backward=True)
    parts, _, cluster, clusters = policy_mod.heads_bwd_plan(x.shape[0])
    res.update(shape=f"rows={x.shape[0]} in={x.shape[1]} logit="
                     f"{[w.shape[0] for w, _ in logit_layers]} value="
                     f"{[w.shape[0] for w, _ in value_layers]} "
                     f"parts={parts} clusters={clusters}x{cluster}",
               folds=["mlp_heads_bwd_reduce"],
               bound_ms=bound, bound_by=bound_by,
               ms=device_ms(lambda: policy_mod.mlp_heads_bwd(*main_case)),
               eager_ms=eager_ms(lambda: policy_mod.mlp_heads_bwd(
                   *main_case)),
               plain_ms=eager_ms(lambda: policy_mod.mlp_heads_bwd_plain(
                   *main_case), iters=20),
               library_ms=eager_ms(library_bwd, iters=50),
               library_device_ms=profiled_device_ms(library_bwd))
    results["mlp_heads_bwd"] = res

    # K19: the optimiser over the shipped policy's leaves
    def fresh_state():
        """The shipped params in the learner's model (its live tensors),
        with fresh moments."""
        return learner.init_state({k: v.cuda() for k, v in params.items()})

    def copies(st):
        return ([p.detach().clone() for p in st.params],
                [torch.zeros_like(p) for p in st.params],
                [torch.zeros_like(p) for p in st.params])

    def step_hp(count, clip):
        return learner_mod.OptimizerStep(
            "adam", cfg.lr, clip, learner_mod.ADAM_B1, learner_mod.ADAM_B2,
            learner_mod.ADAM_EPS,
            learner._bias_correction(learner_mod.ADAM_B1, count),
            learner._bias_correction(learner_mod.ADAM_B2, count))

    res = _new_result()
    opt_err = opt_rel = 0.0
    for scale, clip in ((0.01, cfg.grad_clip), (1.0, cfg.grad_clip),
                        (0.05, "tie")):
        st = fresh_state()
        ref_p, ref_mu, ref_nu = copies(st)
        for count in range(1, 6):
            grads = [torch.randn(p.shape, generator=g).cuda() * scale
                     for p in st.params]
            if clip == "tie":
                norm64 = float(torch.sqrt(sum((t.double() ** 2).sum()
                                              for t in grads)))
                hp = step_hp(count, float(np.float32(norm64)))
            else:
                hp = step_hp(count, clip)
            learner_mod.clip_adam(st, grads, hp)
            learner_mod.clip_adam_plain(ref_p, grads, ref_mu, ref_nu, hp)
        torch.cuda.synchronize()
        err, rel = max_err_scaled(
            tuple(t.detach() for key in ("params", "mu", "nu")
                  for t in getattr(st, key)),
            tuple(ref_p + ref_mu + ref_nu))
        opt_err, opt_rel = max(opt_err, err), max(opt_rel, rel)
    grads = [torch.randn(p.shape, generator=g).cuda() for p in st.params]
    runs = []
    for _ in range(2):
        st = fresh_state()
        learner_mod.clip_adam(st, grads, step_hp(1, cfg.grad_clip))
        runs.append([p.detach().clone() for p in st.params])
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*runs)),
            "clip_adam is not bitwise repeatable")
    st = fresh_state()
    hp = step_hp(1, cfg.grad_clip)
    n_el = sum(p.numel() for p in st.params)
    n_leaves = len(st.params)
    lib_params = [torch.nn.Parameter(p.detach().clone())
                  for p in st.params]
    for p, gr in zip(lib_params, grads):
        p.grad = gr.clone()
    adam = torch.optim.Adam(lib_params, lr=cfg.lr, fused=True)

    def library_step():
        torch.nn.utils.clip_grad_norm_(lib_params, cfg.grad_clip,
                                       foreach=True)
        adam.step()

    plain_p, plain_mu, plain_nu = copies(st)

    def plain_step():
        learner_mod.clip_adam_plain(plain_p, grads, plain_mu, plain_nu, hp)

    step_state = fresh_state()
    plan = learner_mod._optimizer_table(step_state).plan
    # g, p, mu, nu read once, p, mu, nu written once; the norm's 2 and the
    # update's ~16 operations an element
    bound, bound_by = bound_ms(7 * 4 * n_el + 4, 18 * n_el)
    res.update(shape=f"leaves={n_leaves} params={n_el} ctas={plan.ctas}",
               folds=["clip_adam_norm", "clip_adam_reduce",
                      "clip_adam_update"],
               bound_ms=bound, bound_by=bound_by,
               ms=device_ms(lambda: learner_mod.clip_adam(step_state, grads,
                                                          hp)),
               eager_ms=eager_ms(lambda: learner_mod.clip_adam(
                   step_state, grads, hp)),
               # the cluster size measured, not assumed: the same bits
               ms_by_ctas={c: forced_ms("clip_adam", c, lambda: learner_mod.
                   clip_adam(step_state, grads, hp)) for c in (1, 4, 8, 16)},
               max_abs_err=opt_err, max_rel_err=opt_rel,
               plain_ms=eager_ms(plain_step, iters=20),
               library_ms=eager_ms(library_step, iters=50),
               library_device_ms=profiled_device_ms(library_step))
    results["clip_adam"] = res
    return results


# ------------------------------- the pipelined loop and subprocess envs
def _earlier_slice(cfg):
    """A config copy for the phases of earlier slices: the sequential loop
    over in-process envs without per-epoch evaluation, as they ran before
    the pipelined loop, subprocess envs and the evaluation cadence were
    ported (``[pipeline]`` and ``[ring]`` run the configs' own modes)."""
    cfg["epoch_loop"].update(loop_mode="sequential", use_parallel_envs=False)
    cfg["eval_config"]["evaluation_interval"] = None
    return cfg


class _VecEnvs:
    """The ``ParallelVectorEnv``s built while the block runs."""

    def __enter__(self):
        self.made = []
        self._init = ParallelVectorEnv.__init__
        made, init = self.made, self._init

        def wrapped(env, *args, **kwargs):
            init(env, *args, **kwargs)
            made.append(env)

        ParallelVectorEnv.__init__ = wrapped
        return self

    def __exit__(self, *exc):
        ParallelVectorEnv.__init__ = self._init
        return False


class _ShmSegments:
    """The shared-memory segment names of every ``SlabSet`` (so every
    ``TrajRing`` segment) built between ``start()`` and ``leaked()``,
    which restores ``SlabSet`` and lists those names still in /dev/shm."""

    def start(self):
        self.names = []
        self._init = init = SlabSet.__init__
        names = self.names

        def wrapped(slabs, *args, **kwargs):
            init(slabs, *args, **kwargs)
            names.extend(slabs.segment_names())

        SlabSet.__init__ = wrapped
        return self

    def leaked(self):
        SlabSet.__init__ = self._init
        require(len(self.names) > 0, "the run built no shared memory")
        return [n for n in self.names
                if os.path.exists(os.path.join("/dev/shm", n.lstrip("/")))]


def phase_pipeline(params, fx, uniforms, rollout, card):
    """Phase 15, this slice's main path. (1) The recorded JAX collect over
    subprocess envs (``ppo_pipeline_price_mixed.npz``: 8
    env_load32_price_mixed envs seeded 0-7, each in its own worker on the
    shm transport, 64 steps, the shipped policy, the recorded uniforms)
    through the port's ParallelVectorEnv and deferred-fetch collector:
    observations, rewards and dones bit-equal, actions equal, logp within
    1e-5 and values within VALUES_TOL, as [rollout]; its env steps/s beside
    [rollout]'s in-process figure. (2) ``python -m ddls_tpu_torch.train``
    (in this process) on train_config_price_mixed as the config asks it
    (loop_mode pipelined, use_parallel_envs auto, evaluation every epoch,
    3 episodes) at 8 envs x 64 steps, 2 epochs from the shipped export,
    with the launch counters reset just before and read just after (K1-K9
    and K17-K20 must all have run), over subprocess envs on the shm
    transport; then the sequential loop on shm and the pipelined loop on
    the pipe transport: every epoch line (metrics, episodes, evaluation)
    and the checkpoints bit-equal to the first run's."""
    import tempfile

    # (1) the recorded collect over subprocess envs
    pipe_fx = load_pipeline_fixture()
    ref = pipe_fx["traj"]
    model, _, _ = load_export(EXPORT_PATH)
    learner = ppo_mod.PPOLearner(model, fx["cfg"], device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    t_len, n_envs = ref["rewards"].shape
    segments = _ShmSegments().start()
    t0 = time.monotonic()
    vec = ParallelVectorEnv(RampJobPartitioningEnvironment,
                            copy.deepcopy(load_train_config()["env_config"]),
                            n_envs, seeds=list(range(n_envs)),
                            backend="shm")
    try:
        vec.reset()
        startup_s = time.monotonic() - t0
        collector = RolloutCollector(vec, learner, t_len,
                                     deferred_fetch=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = collector.collect(noise=uniforms)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        traj = out["traj"]
        for key, value in traj["obs"].items():
            require(np.array_equal(value, ref["obs"][key]),
                    f"subprocess collect obs {key} differs from the "
                    f"recorded JAX collect")
        ring = vec.traj_ring.stats()
    finally:
        vec.close()
    for key in ("rewards", "dones", "actions"):
        require(np.array_equal(traj[key], ref[key]),
                f"subprocess collect {key} differ from the recorded JAX "
                f"collect")
    logp_err = float(np.abs(traj["logp"] - ref["logp"]).max())
    val_err = max(float(np.abs(traj["values"] - ref["values"]).max()),
                  float(np.abs(out["last_values"]
                               - pipe_fx["last_values"]).max()))
    require(logp_err <= TOL, f"subprocess collect logp off JAX's by "
                             f"{logp_err}")
    require(val_err <= VALUES_TOL, f"subprocess collect values off JAX's "
                                   f"by {val_err}")
    collect = {"env_steps": t_len * n_envs, "wall_s": wall,
               "worker_startup_s": startup_s,
               "env_steps_per_s": t_len * n_envs / wall,
               "in_process_env_steps_per_s": rollout["env_steps_per_s"],
               "env_s": out["timing"]["env_s"],
               "sample_s": out["timing"]["sample_s"], "ring": ring,
               "logp_max_abs_err": logp_err, "values_max_abs_err": val_err}

    # (2) the CLI: pipelined over shm, sequential over shm, pipelined over
    # the pipe transport
    runs = {}
    launches = None
    with tempfile.TemporaryDirectory() as tmp:
        for name, over in (("pipelined_shm", {}),
                           ("sequential_shm", {"loop_mode": "sequential"}),
                           ("pipelined_pipe", {"vec_env_backend": "pipe"})):
            cfg = load_train_config()
            cfg["epoch_loop"].update(num_envs=8, rollout_length=64, **over)
            cfg_path = os.path.join(tmp, f"{name}.json")
            with open(cfg_path, "w") as fh:
                json.dump(cfg, fh)
            argv = ["--config", cfg_path, "--epochs", "2", "--device",
                    "cuda", "--init-export", EXPORT_PATH,
                    "--checkpoint-dir", os.path.join(tmp, name)]
            torch.cuda.synchronize()
            if name == "pipelined_shm":
                kernels.reset_launch_counts()
            t0 = time.monotonic()
            with _VecEnvs() as made:
                lines = _run_train_cli(argv)
            wall = time.monotonic() - t0
            if name == "pipelined_shm":
                launches = kernels.launch_counts()
            backend = "pipe" if name.endswith("pipe") else "shm"
            require(len(made.made) == 1 and made.made[0].backend == backend,
                    f"the {name} run did not collect over {backend} "
                    f"subprocess envs")
            state = torch.load(os.path.join(lines[-1]["checkpoint"],
                                            "train_state.pt"),
                               weights_only=True)
            runs[name] = (lines, state, wall)
    lines0, state0, wall0 = runs["pipelined_shm"]
    epochs = lines0[:-1]
    require([x["loop_mode"] for x in epochs] == ["pipelined"] * 2,
            "the CLI did not run the config's pipelined loop")
    require(all("evaluation" in x for x in epochs),
            "the CLI did not evaluate at the config's interval")
    for name in ("sequential_shm", "pipelined_pipe"):
        lines, state, _ = runs[name]

        def same(line):
            return {k: v for k, v in _deterministic(line).items()
                    if k != "loop_mode"}

        require([same(x) for x in lines] == [same(x) for x in lines0],
                f"the {name} run printed other results than pipelined_shm")
        require(all(torch.equal(a, b) for key in ("params", "mu", "nu")
                    for a, b in zip(state0[key], state[key]))
                and torch.equal(state0["kl_coeff"], state["kl_coeff"]),
                f"the {name} run saved another state than pipelined_shm")
    for name, n in launches.items():
        require(n > 0 or name in AC_SITES or name in DQN_ES_SITES
                or name in SIM_KERNELS,
                f"kernel {name} was not launched by the pipelined loop")
    for line in epochs:
        require(all(np.isfinite(v) for v in line["learner"].values()),
                "non-finite learner metrics")
    leaked = segments.leaked()
    require(not leaked, f"shared memory left in /dev/shm: {leaked}")
    emit("pipeline", card=card, collect=collect, wall_s=wall0,
         epochs=len(epochs),
         env_steps_per_epoch=epochs[0]["env_steps_this_iter"],
         epoch_s=[x["epoch_time"] for x in epochs],
         env_steps_per_s=[x["env_steps_this_iter"] / x["timing"]["collect_s"]
                          for x in epochs],
         timing=[x["timing"] for x in epochs],
         learner=[x["learner"] for x in epochs],
         evaluation=[x["evaluation"] for x in epochs],
         runs_wall_s={k: v[2] for k, v in runs.items()},
         launches={k: v for k, v in launches.items() if v})
    return launches


def phase_ring(card):
    """Phase 16: the IMPALA loop of train_config_impala_price_mixed (32
    subprocess envs on the shm transport, 15 steps, evaluation every epoch)
    at pipeline_depth 1, 2 epochs from the shipped export: finite metrics,
    each batch's params age 0 then 1, a 3-segment trajectory ring whose
    segments are all released, and no /dev/shm segment left once it
    closes; launch counters around it."""
    cfg = load_train_config(IMPALA_CONFIG_PATH)
    cfg["epoch_loop"]["pipeline_depth"] = 1
    segments = _ShmSegments().start()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    loop = build_loop(cfg, "cuda", EXPORT_PATH)
    try:
        require(isinstance(loop.vec_env, ParallelVectorEnv)
                and loop.vec_env.backend == "shm",
                "the IMPALA loop did not collect over shm subprocess envs")
        results = [loop.run() for _ in range(2)]
        learner = [dict(r["learner"]) for r in results]
        stats = loop.ring_stats()
    finally:
        loop.close()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    require([m["params_age_updates"] for m in learner] == [0, 1],
            "the depth-1 batches are not 0 then 1 update stale")
    require(all(np.isfinite(v) for m in learner for v in m.values()),
            "non-finite IMPALA metrics at depth 1")
    require(stats["segments"] == 3 and stats["stalls"] == 0,
            f"the ring is not 3 segments without stalls: {stats}")
    leaked = segments.leaked()
    require(not leaked, f"the ring left /dev/shm segments: {leaked}")
    for name in ("vtrace", "ac_loss", "mlp_heads", "mlp_heads_bwd",
                 "clip_adam", "minibatch_gather", "mask_sample_logp"):
        require(launches[name] > 0, f"the depth-1 IMPALA loop did not "
                                    f"launch {name}")
    emit("ring", card=card, wall_s=wall,
         epoch_s=[r["epoch_time"] for r in results],
         timing=[r["timing"] for r in results], learner=learner,
         evaluation=[r.get("evaluation") for r in results], ring=stats,
         launches={k: v for k, v in launches.items() if v})
    return launches


# --------------------------------------- the array lookahead engine (K21)
# the main path's call: one 32-server pricing decision (6 candidates,
# padded to 512 ops and 16,384 deps)
LOOKAHEAD_MAIN_GROUP = "price32"
# the [lookahead] rollout: envs x steps of the shipped policy
LOOKAHEAD_ENVS, LOOKAHEAD_STEPS = 4, 32
# the cluster hook's episode on the card: FixedDegreePacking(8)'s decisions
LOOKAHEAD_HOOK_DECISIONS = 64
# the JAX pricing backend against the C++ engine
# (tests/test_candidate_pricing.py:124-142)
PRICE_REL, PRICE_ABS = 2e-4, 1e-5


def _lanes_on_card(group, dtype):
    args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in group["args"]]
    return [a.to(dtype) if a.is_floating_point() else a for a in args]


def _cpp_lanes(group):
    """Each lane of a recorded group as the C++ engine's exact-size
    float64 arrays (the float32 lanes widened)."""
    from ddls_tpu_torch.sim.lookahead_arrays import LookaheadArrays

    out = []
    for b, (n, m) in enumerate(zip(group["n"], group["m"])):
        a = [np.ascontiguousarray(x[b, :n] if i < 5 else x[b, :m])
             for i, x in enumerate(group["args"])]
        for i in (0, 3, 5, 11):
            a[i] = a[i].astype(np.float64)
        out.append(LookaheadArrays(*a, num_workers=group["num_workers"],
                                   num_channels=group["num_channels"]))
    return out


def check_lookahead_kernel():
    """Phase 3, K21 on every recorded group of lanes
    (``ddls_tpu_torch/data/lookahead_lanes_recorded.npz``: the candidates
    of the first decision of the 32-, 72- and 128-server surfaces, the
    cluster hook's lookaheads on env_load32, the edge cases), in float32
    and float64: bit-equal to its plain version on the card (and its tick
    counts), bitwise across two runs; in float32 bit-equal to the recorded
    JAX answers; in float64, on the real lanes (not the edge cases' tied
    scores), within 1e-9 relative of the C++ engine (lanes it cannot
    finish are the ones K21 reports not ok). Timed at the main
    path's call (one 32-server pricing decision), beside the C++ engine's
    host time for the same lanes (there is no library call)."""
    from ddls_tpu_torch.native import run_lookahead

    groups = load_lookahead_lanes()
    res = _new_result(groups={})
    for name, g in groups.items():
        kw = dict(num_workers=g["num_workers"],
                  num_channels=g["num_channels"])
        lanes = len(g["n"])
        info = {"lanes": lanes, "pad": list(g["args"][0].shape[1:]) +
                list(g["args"][5].shape[1:]) + [g["args"][12].shape[2]],
                "num_workers": g["num_workers"],
                "num_channels": g["num_channels"]}
        for dtype in (torch.float32, torch.float64):
            args = _lanes_on_card(g, dtype)
            ticks = torch.empty(lanes, dtype=torch.int32, device="cuda")
            out = lookahead_mod.lookahead(*args, ticks=ticks, **kw)
            again = lookahead_mod.lookahead(*args, **kw)
            plain = lookahead_mod.lookahead_plain(*args, **kw)
            torch.cuda.synchronize()
            for o, a, p in zip(out, again, plain):
                require(torch.equal(o, p), f"K21 differs from its plain "
                                           f"version on {name} {dtype}")
                require(torch.equal(o, a), f"K21 is not bitwise "
                                           f"repeatable on {name}")
            require(torch.equal(ticks, plain[5]),
                    f"K21's tick counts differ from the plain version's "
                    f"on {name}")
            ok = out[4].cpu().numpy()
            if dtype == torch.float32:
                for o, want in zip(out, g["jax"]):
                    require(np.array_equal(o.cpu().numpy(), want),
                            f"K21 differs from the recorded JAX answer on "
                            f"{name}")
                info["ticks"] = ticks.tolist()
                info["ok"] = ok.tolist()
                continue
            if name == "edge":
                # tied scores select every tied op (the JAX engine's rule);
                # the C++ engine keeps distinct scores, so it is held on
                # the recorded real lanes only
                continue
            vals = torch.stack(out[:4], 1).cpu().numpy()
            rel = 0.0
            for b, arrays in enumerate(_cpp_lanes(g)):
                want = run_lookahead(arrays)
                require((want is not None) == bool(ok[b]),
                        f"K21 and the C++ engine disagree on whether lane "
                        f"{b} of {name} finishes")
                if want is not None:
                    rel = max(rel, max(abs(v - w) / max(abs(w), 1e-300)
                                       for v, w in zip(vals[b], want)))
            require(rel <= 1e-9, f"K21 float64 off the C++ engine by {rel} "
                                 f"on {name}")
            info["f64_max_rel_err_vs_cpp"] = rel
        res["groups"][name] = info

    g = groups[LOOKAHEAD_MAIN_GROUP]
    kw = dict(num_workers=g["num_workers"], num_channels=g["num_channels"])
    args = _lanes_on_card(g, torch.float32)
    args64 = _lanes_on_card(g, torch.float64)
    lanes = len(g["n"])
    links = g["args"][12].shape[2]
    ticks = np.asarray(res["groups"][LOOKAHEAD_MAIN_GROUP]["ticks"])
    # bytes: the two valid masks in full (they alone say which slots are
    # padding), the other fields of each lane's valid ops and deps once,
    # the outputs once; operations: every valid op and every channel
    # column of every valid dep visited once a tick, for the ticks these
    # lanes need
    op_fields = sum(args[i].element_size() for i in (0, 2, 3, 4))
    dep_fields = (sum(args[i].element_size() for i in (5, 7, 8, 9, 10, 11))
                  + links * args[12].element_size())
    nbytes = (_nbytes(args[1], args[6]) + int(np.sum(g["n"])) * op_fields
              + int(np.sum(g["m"])) * dep_fields + lanes * (4 * 4 + 1 + 4))
    ops = float(np.sum(ticks * (g["n"] + g["m"] * links)))
    bound, bound_by = bound_ms(nbytes, ops)
    cpp = _cpp_lanes(g)
    t0 = time.perf_counter()
    for _ in range(5):
        for arrays in cpp:
            run_lookahead(arrays)
    cpp_ms = (time.perf_counter() - t0) / 5 * 1e3
    res.update(
        shape=(f"{LOOKAHEAD_MAIN_GROUP}: lanes={lanes} N={args[0].shape[1]} "
               f"E={args[5].shape[1]} L={links} W={g['num_workers']} "
               f"C={g['num_channels']} ticks={ticks.tolist()}"),
        bound_ms=bound, bound_by=bound_by,
        ms=device_ms(lambda: lookahead_mod.lookahead(*args, **kw),
                     iters=10, replays=3),
        f64_ms=device_ms(lambda: lookahead_mod.lookahead(*args64, **kw),
                         iters=10, replays=3),
        eager_ms=eager_ms(lambda: lookahead_mod.lookahead(*args, **kw),
                          iters=10),
        plain_ms=eager_ms(lambda: lookahead_mod.lookahead_plain(
            *args, **kw), iters=2),
        cpp_engine_host_ms=cpp_ms, calls_per_step=1)
    return {"lookahead": res}


# ------------------------------- K21 and K24 over thread-block clusters
# every cluster size a launch may be given (1-16 CTAs a lane), and the
# sizes whose device times the sweep reports
CLUSTER_SIZES = tuple(range(1, kernels.MAX_CLUSTER + 1))
CLUSTER_TIMED = (1, 2, 4, 8, 16)
# the decisions of the recorded 8-lane replay whose K24 and K21 calls are
# held at every cluster size, in float32 and in float64
CLUSTER_DECISIONS = {torch.float32: (0, 7, 15), torch.float64: (0,)}


def _hold_every_size(what, run, plain, sizes=CLUSTER_SIZES):
    """``run(g)`` at every cluster size ``g`` against ``plain`` (the plain
    version's outputs on the same inputs): bit for bit (NaN equal to
    NaN), integers equal. Returns the number of calls held."""
    for g in sizes:
        got = run(g)
        torch.cuda.synchronize()
        for i, (o, p) in enumerate(zip(got, plain)):
            diff = device_env_fixture.max_difference(o, p)
            require(diff == 0, f"{what} at cluster {g}: output {i} differs "
                               f"from its plain version by {diff}")
    return len(sizes)


def _k21_indexed(raw, cfg, skip, dev, g=None, ticks=None):
    return lookahead_mod.lookahead_indexed(
        cfg, raw["ots"], raw["op_score"], raw["times"], raw["is_flow"],
        raw["dep_score"], raw["chan"], dev.t, num_workers=dev.et.n_srv,
        num_channels=dev.et.n_chan, ticks=ticks, skip=skip, cluster=g)


def _k21_indexed_held(raw, cfg, skip, dev, g):
    ticks = torch.empty(cfg.shape[0], dtype=torch.int32, device="cuda")
    return _k21_indexed(raw, cfg, skip, dev, g, ticks) + (ticks,)


def _k21_indexed_plain(raw, cfg, skip, dev):
    return lookahead_mod.lookahead_plain(
        *lookahead_mod.gather_indexed(cfg, raw["ots"], raw["op_score"],
                                      raw["times"], raw["is_flow"],
                                      raw["dep_score"], raw["chan"], dev.t),
        num_workers=dev.et.n_srv, num_channels=dev.et.n_chan, skip=skip)


def _episode_calls(et, fx, dtype, lanes, decisions):
    """The recorded replay of banks ``lanes`` up to the last of
    ``decisions``: each of those decisions' config rows, active lanes and
    ``evaluate`` outputs (K23, K24 and K21's inputs and outputs)."""
    ek = device_env.episode_kernels(et, device="cuda", dtype=dtype)
    bank = _episode_bank(fx["banks"], lanes, dtype)
    acts = torch.from_numpy(np.stack([fx["actions"]] * len(lanes))).to(
        "cuda", torch.int32)
    trace = {name: torch.zeros(acts.shape, dtype=want or dtype,
                               device="cuda")
             for name, want in device_env.TRACE_FIELDS}
    state = ek.init_state(bank, acts)
    calls = []
    for d in range(max(decisions) + 1):
        raw = ek.evaluate(state)
        if d in decisions:
            calls.append((state["cfg"].clone(), state["active"].clone(),
                          raw))
        device_env.episode_step(ek, state, bank, acts, raw, trace, d)
    return ek, calls


def check_cluster_kernels(card):
    """[cluster]: K24 and both K21 entries at every cluster size 1-16
    against their plain versions, bit for bit, on the calls the main path
    makes at full width (the shipped surface: 45 configs, N 480, M
    13,072): the recorded 8-lane replay's decisions ``CLUSTER_DECISIONS``
    of each float type (K24, the indexed K21 with ``skip``), its
    banks 0 and 0-1 at decision 0 (lanes 1 and 2), the 72 pricing rows of
    the oracle step at decision 0 (K24, the indexed K21 without the memo),
    and the per-lane K21 on every recorded group of lanes (float32 and
    float64). Then the sweep: device ms a call (CUDA graph) of K24 and
    the indexed K21 at 8 lanes, K21 at the main path's pricing decision
    (price32) and at the 72 rows, at each size of ``CLUSTER_TIMED``, with
    the clusters of K24 of each size the card runs at once and the size
    each wrapper takes (K24 chooses it from those counts; K21 takes
    ``lookahead.CLUSTER``). Returns each redesigned row's size as the main
    path takes it."""
    fx = device_env_fixture.load_device_env_fixture()
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    held = {"price_and_score": 0, "lookahead (indexed)": 0,
            "lookahead": 0}
    timed = {}
    for dtype in (torch.float32, torch.float64):
        for lanes, decisions in ((list(range(8)), CLUSTER_DECISIONS[dtype]),
                                 ([0], (0,)), ([0, 1], (0,))):
            ek, calls = _episode_calls(et, fx, dtype, lanes, decisions)
            dev = ek.dev
            for d, (cfg, active, raw) in zip(decisions, calls):
                what = f"{len(lanes)} lanes, decision {d}, {dtype}"
                ots, skip = raw["ots"], ~active
                held["price_and_score"] += _hold_every_size(
                    f"K24 ({what})",
                    lambda g: device_env.price_and_score(ots, cfg, dev, g),
                    device_env.price_and_score_plain(ots, cfg, dev))
                held["lookahead (indexed)"] += _hold_every_size(
                    f"K21 indexed ({what})",
                    lambda g: _k21_indexed_held(raw, cfg, skip, dev, g),
                    _k21_indexed_plain(raw, cfg, skip, dev))
                if dtype == torch.float32 and len(lanes) == 8 and d == 0:
                    timed["episode"] = (dev, cfg, raw, skip)
    # the oracle step's 72 pricing rows (8 lanes x 9 degrees)
    ek = device_env.episode_kernels(et, device="cuda", dtype=torch.float32)
    dev = ek.dev
    bank = _episode_bank(fx["banks"], list(range(8)), torch.float32)
    state = ek.init_state(bank)
    rows = ek.price_rows(state, bank)
    cfg72, ots72 = rows["cfg"], rows["alloc"][0]
    raw72 = dict(zip(("times", "is_flow", "chan", "op_score", "dep_score"),
                     device_env.price_and_score(ots72, cfg72, dev)[:5]),
                 ots=ots72)
    has_job = (state["queue_row"] >= 0) & ~state["done"]
    skip72 = ~has_job.repeat_interleave(dev.n_deg)
    held["price_and_score"] += _hold_every_size(
        "K24 (72 pricing rows)",
        lambda g: device_env.price_and_score(ots72, cfg72, dev, g),
        device_env.price_and_score_plain(ots72, cfg72, dev))
    held["lookahead (indexed)"] += _hold_every_size(
        "K21 indexed (72 pricing rows)",
        lambda g: _k21_indexed_held(raw72, cfg72, skip72, dev, g),
        _k21_indexed_plain(raw72, cfg72, skip72, dev))
    # the per-lane entry on the recorded groups
    groups = load_lookahead_lanes()
    for name, grp in groups.items():
        kw = dict(num_workers=grp["num_workers"],
                  num_channels=grp["num_channels"])
        for dtype in (torch.float32, torch.float64):
            args = _lanes_on_card(grp, dtype)

            def run(g):
                ticks = torch.empty(args[0].shape[0], dtype=torch.int32,
                                    device="cuda")
                return lookahead_mod.lookahead(*args, ticks=ticks,
                                               cluster=g, **kw) + (ticks,)

            held["lookahead"] += _hold_every_size(
                f"K21 on {name} ({dtype})", run,
                lookahead_mod.lookahead_plain(*args, **kw))

    # the sweep
    dev8, cfg8, raw8, skip8 = timed["episode"]
    main = groups[LOOKAHEAD_MAIN_GROUP]
    main_args = _lanes_on_card(main, torch.float32)
    main_kw = dict(num_workers=main["num_workers"],
                   num_channels=main["num_channels"])
    calls = {
        "price_and_score (8 lanes)": (
            lambda g: device_env.price_and_score(raw8["ots"], cfg8, dev8, g),
            device_env.price_cluster(8, dev8), 100),
        "price_and_score (72 rows)": (
            lambda g: device_env.price_and_score(ots72, cfg72, dev, g),
            device_env.price_cluster(72, dev), 100),
        "lookahead skip (8 lanes)": (
            lambda g: _k21_indexed(raw8, cfg8, skip8, dev8, g),
            lookahead_mod.CLUSTER, 20),
        "lookahead (72 rows)": (
            lambda g: _k21_indexed(raw72, cfg72, skip72, dev, g),
            lookahead_mod.CLUSTER, 10),
        "lookahead (price32)": (
            lambda g: lookahead_mod.lookahead(*main_args, cluster=g,
                                              **main_kw),
            lookahead_mod.CLUSTER, 20)}
    sweep = {}
    for name, (fn, chosen, iters) in calls.items():
        sizes = sorted(set(CLUSTER_TIMED) | {chosen})
        sweep[name] = {"chosen": chosen, "device_ms": {
            g: device_ms(lambda: fn(g), iters=iters, replays=3)
            for g in sizes}}
    fits = {g: kernels.cached_query(
        "pricing", "ddls_price_and_score_clusters", et.pads.n_ops,
        et.pads.n_deps, et.pads.n_groups, et.pads.group_edges,
        et.pads.n_sync, et.pads.n_o2o, *dev.st.ramp_shape, g, 0)
        for g in CLUSTER_TIMED}
    emit("cluster", card=card, sms=kernels.sm_count(), held_calls=held,
         sizes_held=len(CLUSTER_SIZES), sweep=sweep,
         price_and_score_clusters_at_once=fits)
    return {"lookahead": sweep["lookahead (price32)"]["chosen"],
            "lookahead (skip)": sweep["lookahead skip (8 lanes)"]["chosen"],
            "price_and_score": sweep["price_and_score (8 lanes)"]["chosen"]}


# K23's fuzzed holds: rows a launch (one lane; the replay's 8 lanes; the
# oracle step's 72 pricing rows) and seeds of each (rows, entry, float
# type, surface)
PLACEMENT_ROWS = (1, 8, 72)
PLACEMENT_SEEDS = 3


def check_placement_kernel(card):
    """K23 on fuzzed states (``sim/fixture.py`` ``fuzzed_placements``):
    both entries (plain, and with the state-lane index over rows // 9
    lanes), float32 and float64, at 1, 8 and 72 rows, on the shipped
    32-server surface and on a 64-server ramp whose occupancy masks take
    two words (``multi_word_tables``); every call bit-equal to its plain
    version. Emits the calls held, the rows placed and each case's device
    ms a launch (CUDA graph)."""
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    held = placed = rows_held = 0
    ms = {}
    for surface, tables in (("shipped", et), (
            "multi_word", device_env_fixture.multi_word_tables(et))):
        for dtype in (torch.float32, torch.float64):
            dev = device_env.device_tables(tables, "cuda", dtype)
            for rows in PLACEMENT_ROWS:
                for indexed in (False, True):
                    what = (f"{surface} servers={tables.n_srv} "
                            f"{str(dtype)[6:]} rows={rows} "
                            f"{'indexed' if indexed else 'plain'}")
                    for seed in range(PLACEMENT_SEEDS):
                        args = device_env_fixture.fuzzed_placements(
                            tables, dev, rows, seed, indexed)
                        got = device_env.allocate_job(*args[:3], dev,
                                                      args[3])
                        want = device_env.allocate_job_plain(
                            *args[:3], dev, args[3])
                        torch.cuda.synchronize()
                        require(all(torch.equal(g, w)
                                    for g, w in zip(got, want)),
                                f"K23 differs from its plain version on "
                                f"fuzzed states ({what}, seed {seed})")
                        held += 1
                        rows_held += rows
                        placed += int(got[2].sum())
                    ms[what] = device_ms(lambda: device_env.allocate_job(
                        *args[:3], dev, args[3]))
    require(0 < placed < rows_held, "the fuzzed states placed every row "
                                    "or none")
    emit("placement", card=card, held_calls=held, rows_held=rows_held,
         rows_placed=placed, device_ms_per_launch=ms)


# the wide surfaces (ramps 4 x 4 x 8 | 16: 128 and 256 servers, 16,256 and
# 65,280 channels) and the replay's decisions on them; K23 also at 160
# servers (4 x 4 x 10), and its fuzzed rows (8, and 72 for the indexed
# entry)
WIDE_RACKS, WIDE_LANES, WIDE_DECISIONS = (8, 16), 8, 12
WIDE_K23_RACKS = (8, 10, 16)


def check_wide_surfaces(card):
    """Phase 3, surfaces wider than the configs' (128 and 256 servers, the
    shipped jobs), where K25 once took at most 128 slots and K21 planned
    no float64 launch (the limits ROADMAP Queue C listed): K21's indexed
    entry on 8 lanes of random placements of random configurations (the
    largest among them, a third of the lanes skipped) at the default
    cluster and on one CTA, in float32 and float64 (its channel table in
    the lane's workspace where a CTA cannot hold it); K25's replay of 12
    decisions at 8 lanes on the recorded banks cut to 12 jobs, in float32,
    its inputs from the device env's own evaluation (K23, K24, K21), and
    K29 on 72 rows of the episode's last state; K23, both entries, float32
    and float64, on fuzzed states at 128, 160 and 256 servers (its shape
    tables from global memory where they do not fit shared memory, the
    C entry's plan held against the Python mirror's): every call bit-equal
    to its plain version (ticks too). Emits the calls held, the forms each
    surface takes and each kernel's device ms a launch."""
    fx = device_env_fixture.load_device_env_fixture()
    held, ms, forms = 0, {}, {}
    optin = kernels.cached_query("placement", "ddls_smem_optin")
    k23_row = None
    for racks in WIDE_K23_RACKS:
        et = device_env_fixture.wide_episode_tables(racks)
        n_srv = et.n_srv
        forms[n_srv] = {}
        for dtype in (torch.float32, torch.float64):
            dev = device_env.device_tables(et, "cuda", dtype)
            sizes = device_env.allocate_job_sizes(dev)
            is_f64 = dtype == torch.float64
            plan = device_env.allocate_job_plan(sizes, is_f64, optin)
            packed = kernels.query("placement", "ddls_allocate_job_smem",
                                   *sizes, int(is_f64), 0)
            require(plan is not None and packed == plan.packed(),
                    f"K23's plan on {n_srv} servers ({dtype}) is not the "
                    f"Python mirror's")
            k23 = f"k23 {str(dtype)[6:]}"
            forms[n_srv][k23] = {"form": device_env.ALLOC_FORMS[plan.form],
                                 "rows_a_cta": plan.rows,
                                 "smem": plan.smem, "smem_optin": optin}
            for indexed in (False, True):
                rows = 72 if indexed else WIDE_LANES
                # the kernels line's global-form row counts the launches
                # of 256 servers' float32 plain-entry calls, from 0
                counted = n_srv == 256 and not indexed and not is_f64
                if counted:
                    kernels.reset_launch_counts()
                for seed in range(2):
                    args = device_env_fixture.fuzzed_placements(
                        et, dev, rows, seed, indexed)
                    got = device_env.allocate_job(*args[:3], dev, args[3])
                    want = device_env.allocate_job_plain(*args[:3], dev,
                                                         args[3])
                    torch.cuda.synchronize()
                    require(all(torch.equal(x, y)
                                for x, y in zip(got, want)),
                            f"K23 differs from its plain version on {n_srv} "
                            f"servers ({dtype}, indexed {indexed})")
                    held += 1
                what = "allocate_job_indexed" if indexed else "allocate_job"
                if counted:
                    launched = kernels.launch_counts()[what]

                def call():
                    return device_env.allocate_job(*args[:3], dev, args[3])

                key = f"{what} {n_srv} servers {str(dtype)[6:]} rows={rows}"
                ms[key] = device_ms(call)
                if counted:
                    cfg_np = args[2].cpu().numpy()[None]
                    k23_row = {
                        "launches": launched, "ms": ms[key],
                        "eager_ms": eager_ms(call),
                        "plain_ms": eager_ms(lambda: device_env.
                                             allocate_job_plain(
                                                 *args[:3], dev, args[3]),
                                             iters=3),
                        "bound": bound_ms(*_k23_work(
                            et, cfg_np, np.ones(cfg_np.shape), 4)),
                        "form": device_env.ALLOC_FORMS[plan.form],
                        "shape": f"rows={rows} servers={n_srv} float32 "
                                 f"fuzzed states"}
    for racks in WIDE_RACKS:
        et = device_env_fixture.wide_episode_tables(racks)
        n_srv = et.n_srv
        forms[n_srv].update({"channels": et.n_chan, "slots_a_lane":
                             device_env.episode_slots_a_lane(n_srv)})
        for dtype in (torch.float32, torch.float64):
            dev = device_env.device_tables(et, "cuda", dtype)
            rng = np.random.RandomState(racks)
            cfg = rng.randint(0, dev.n_cfg, WIDE_LANES)
            cfg[0] = int(np.argmax(et.tables["n_deps"]))
            valid = et.tables["op_valid"][cfg]
            ots = np.where(valid, rng.randint(0, n_srv, valid.shape), -1)
            cfg_t = torch.from_numpy(cfg.astype(np.int32)).cuda()
            ots_t = torch.from_numpy(ots.astype(np.int32)).cuda()
            skip = torch.from_numpy(rng.rand(WIDE_LANES) < 1 / 3).cuda()
            times, is_flow, chan, op_score, dep_score, _ = \
                device_env.price_and_score_plain(ots_t, cfg_t, dev)
            kw = dict(num_workers=n_srv, num_channels=et.n_chan)
            plain = lookahead_mod.lookahead_plain(
                *lookahead_mod.gather_indexed(cfg_t, ots_t, op_score, times,
                                              is_flow, dep_score, chan,
                                              dev.t), skip=skip, **kw)

            def k21(g=None):
                ticks = torch.empty(WIDE_LANES, dtype=torch.int32,
                                    device="cuda")
                return lookahead_mod.lookahead_indexed(
                    cfg_t, ots_t, op_score, times, is_flow, dep_score, chan,
                    dev.t, ticks=ticks, skip=skip, cluster=g, **kw) + (
                        ticks,)

            for g in (None, 1):
                got = k21(g)
                torch.cuda.synchronize()
                require(all(device_env_fixture.max_difference(o, w) == 0
                            for o, w in zip(got, plain)),
                        f"K21 differs from its plain version on {n_srv} "
                        f"servers ({dtype}, cluster {g})")
                held += 1
            ms[f"lookahead {n_srv} servers {str(dtype)[6:]}"] = \
                device_ms(k21)
        # K25's replay and K29, float32
        ek = device_env.episode_kernels(et, device="cuda",
                                        dtype=torch.float32)
        lanes = [i % 8 for i in range(WIDE_LANES)]
        J = WIDE_DECISIONS
        cut = {k: np.ascontiguousarray(fx["banks"][k][lanes, :J])
               for k in ("type", "steps", "sla_frac")}
        cut["arrival_t"] = np.concatenate(
            [fx["banks"]["arrival_t"][lanes, :J],
             np.full((WIDE_LANES, 1), np.inf)], 1)
        bank = {k: torch.from_numpy(np.ascontiguousarray(cut[k])).to(
            "cuda", want or torch.float32)
            for k, want in device_env.BANK_FIELDS}
        acts = torch.from_numpy(np.random.RandomState(racks).choice(
            [1, 2, 4, 8, 16], (WIDE_LANES, J)).astype(np.int32)).cuda()
        state = ek.init_state(bank, acts)
        trace = {k: torch.zeros((WIDE_LANES, J), dtype=want or torch.float32,
                                device="cuda")
                 for k, want in device_env.TRACE_FIELDS}
        running = 0
        for d in range(J):
            raw = ek.evaluate(state)
            s2 = {k: v.clone() for k, v in state.items()}
            t2 = {k: v.clone() for k, v in trace.items()}
            device_env.episode_step(ek, state, bank, acts, raw, trace, d)
            device_env.episode_step_plain(ek, s2, bank, acts, raw, t2, d)
            torch.cuda.synchronize()
            require(all(device_env_fixture.max_difference(state[k], s2[k])
                        == 0 for k in state)
                    and all(device_env_fixture.max_difference(
                        trace[k], t2[k]) == 0 for k in trace),
                    f"K25 differs from its plain version on {n_srv} servers "
                    f"at decision {d}")
            held += 1
            running = max(running, int(state["slot_valid"].sum(1).max()))
        require(bool(trace["accept"].any()), f"no job placed on {n_srv} "
                                             f"servers")
        forms[n_srv]["most_running_slots"] = running
        ms[f"episode_step {n_srv} servers float32"] = device_ms(
            lambda: device_env.episode_step(
                ek, {k: v.clone() for k, v in s2.items()}, bank, acts, raw,
                {k: v.clone() for k, v in t2.items()}, J - 1))
        rows = WIDE_LANES * 9
        rng = np.random.RandomState(rows)
        cfg = rng.randint(0, ek.dev.n_cfg, rows)
        valid = et.tables["op_valid"][cfg]
        ots = torch.from_numpy(np.where(valid, rng.randint(
            0, n_srv, valid.shape), -1).astype(np.int32)).cuda()
        cfg_t = torch.from_numpy(cfg.astype(np.int32)).cuda()
        _, is_flow, chan, _, _, finite_ok = device_env.price_and_score_plain(
            ots, cfg_t, ek.dev)
        ok_place = torch.from_numpy(rng.rand(rows) < 0.8).cuda()
        ok_la = torch.from_numpy(rng.rand(rows) < 0.9).cuda()
        t_step = torch.from_numpy(rng.uniform(0, 50, rows)).to(
            "cuda", torch.float32)
        args = (is_flow, chan, ok_place, finite_ok, t_step, ok_la, state,
                bank)
        got = device_env.price_reduce(*args, cfg_t, ek.dev.t["n_deps"])
        want = device_env.price_reduce_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"K29 differs from its plain version on {n_srv} servers")
        held += 1
        ms[f"price_reduce {n_srv} servers float32"] = device_ms(
            lambda: device_env.price_reduce(*args, cfg_t,
                                            ek.dev.t["n_deps"]))
    emit("wide", card=card, held_calls=held, surfaces=forms,
         device_ms_per_launch=ms)
    require(k23_row is not None and k23_row["form"] == "global_tables",
            "K23 took no global form on 256 servers")
    return k23_row


def _price_tuples_close(got, want) -> float:
    """The largest |got - want| / (PRICE_ABS + PRICE_REL |want|) over every
    priced candidate; None prices must match."""
    worst = 0.0
    require(set(got) == set(want), "the backends priced other degrees")
    for d, w in want.items():
        require((got[d] is None) == (w is None),
                f"degree {d}: one backend found it unplaceable")
        if w is not None:
            for g_, w_ in zip(got[d], w):
                worst = max(worst, abs(g_ - w_) / (PRICE_ABS
                                                   + PRICE_REL * abs(w_)))
    return worst


def _packing_episode(env_cfg, decisions: int):
    """FixedDegreePacking(8)'s episode on ``env_cfg`` from reset(7009), up
    to ``decisions`` decisions: (decisions taken, the cluster's episode
    stats)."""
    env = RampJobPartitioningEnvironment(**copy.deepcopy(env_cfg))
    actor = FixedDegreePacking(8)
    obs = env.reset(seed=7009)
    done, taken = False, 0
    while not done and taken < decisions:
        obs, _, done, _ = env.step(actor.compute_action(obs))
        taken += 1
    return taken, copy.deepcopy(dict(env.cluster.episode_stats))


def phase_lookahead_hook(card):
    """Phase 17a: the cluster hook on the card. ``ppo_device_trained``'s
    surface (plain env_load32, no candidate pricing, so every cache-miss
    lookahead of a mounted job reaches the hook) with
    ``use_jax_lookahead=True``: FixedDegreePacking(8)'s first
    ``LOOKAHEAD_HOOK_DECISIONS`` decisions from seed 7009, the launch
    counters reset just before and read just after (K21 must have run,
    one launch a lookahead); the episode's stats against the same
    episode on the C++ engine, as ``tests/test_torch_lookahead.py`` holds
    the plain engine against the host engine (job counts equal,
    completion and communication times within rel 1e-4)."""
    env_cfg = dict(load_checkpoint_fixture("ppo_device_trained")[
        "env_config"], use_jax_lookahead=True, device="cuda")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    taken, stats = _packing_episode(env_cfg, LOOKAHEAD_HOOK_DECISIONS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    require(launches["lookahead"] > 0, "the cluster hook did not launch K21")
    t0 = time.monotonic()
    native_taken, native = _packing_episode(
        dict(env_cfg, use_jax_lookahead=False), LOOKAHEAD_HOOK_DECISIONS)
    native_wall = time.monotonic() - t0
    require(taken == native_taken, "the hook's episode is of another length")
    for key in ("num_jobs_completed", "num_jobs_blocked"):
        require(stats[key] == native[key],
                f"the hook's {key} differs from the C++ engine's")
    worst = 0.0
    for key, tol_abs in (("job_completion_time", 0.0),
                         ("job_communication_overhead_time", 1e-6)):
        got = np.asarray(stats[key], np.float64)
        want = np.asarray(native[key], np.float64)
        require(got.shape == want.shape, f"the hook's {key} differs in shape")
        if got.size:
            worst = max(worst, float(np.max(
                np.abs(got - want) / (tol_abs + 1e-4 * np.abs(want)))))
    require(worst <= 1.0, f"the hook's episode off the C++ engine's by "
                          f"{worst} of the rel 1e-4 tolerance")
    require(stats["num_jobs_completed"] > 0, "the hook's episode completed "
                                             "no job")
    emit("lookahead_hook", card=card, decisions=taken,
         k21_launches=launches["lookahead"], wall_s=wall,
         native_wall_s=native_wall, tolerance_used=worst,
         jobs_completed=stats["num_jobs_completed"],
         jobs_blocked=stats["num_jobs_blocked"])
    return launches


def phase_lookahead(params, recorded_groups, card):
    """Phase 17: the shipped policy's in-process rollout (4
    env_load32_price_mixed envs seeded 0-3, 32 steps, its own samples)
    with ``candidate_pricing="jax"`` and ``use_jax_lookahead=True`` on the
    card, the launch counters reset just before and read just after (K21
    must have run). Each of the main path's K21 calls (the candidates the
    memo did not hold) is recorded in the window and, after it, run again
    on K21 (it must give the same prices) and on the C++ engine (within
    rel 2e-4, abs 1e-5), each timed: pricing ms per call of each backend
    over the same candidates. Prints the recorded lanes' tick counts
    beside them (``recorded_groups``: phase 3's K21 groups)."""
    from ddls_tpu_torch.sim import candidate_pricing as pricing_mod

    cfg = load_train_config()
    env_cfg = dict(copy.deepcopy(cfg["env_config"]), candidate_pricing="jax",
                   use_jax_lookahead=True, device="cuda")
    model, _, _ = load_export(EXPORT_PATH)
    fx_cfg = load_train_fixture()["cfg"]
    learner = ppo_mod.PPOLearner(model, fx_cfg, device="cuda")
    learner.init_state({k: v.cuda() for k, v in params.items()})
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(env_cfg)) for _ in range(LOOKAHEAD_ENVS)],
        seeds=list(range(LOOKAHEAD_ENVS)))
    collector = RolloutCollector(vec, learner, LOOKAHEAD_STEPS)
    main_s = []
    calls = []  # (cluster, pending candidates, the main path's prices)
    price = RampJobPartitioningEnvironment._price_candidates
    evaluate = pricing_mod._evaluate

    def timed_price(env):
        t_start = time.perf_counter()
        price(env)
        main_s.append(time.perf_counter() - t_start)

    def recorded_evaluate(cluster, pending, backend):
        out = evaluate(cluster, pending, backend)
        calls.append((cluster, pending, out))
        return out

    RampJobPartitioningEnvironment._price_candidates = timed_price
    pricing_mod._evaluate = recorded_evaluate
    try:
        vec.reset()
        main_s.clear()
        calls.clear()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        out = collector.collect(generator=torch.Generator(
            device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
    finally:
        RampJobPartitioningEnvironment._price_candidates = price
        pricing_mod._evaluate = evaluate
    require(launches["lookahead"] > 0,
            "the jax-pricing rollout did not launch K21")
    require(np.isfinite(out["traj"]["rewards"]).all(),
            "non-finite rollout rewards")

    timing = {"jax": [], "native": []}
    worst, priced = 0.0, 0
    for cluster, pending, main_out in calls:
        t_start = time.perf_counter()
        again = evaluate(cluster, pending, "jax")
        timing["jax"].append(time.perf_counter() - t_start)
        require(again == main_out, "K21 priced the main path's candidates "
                                   "differently when run again")
        t_start = time.perf_counter()
        native = evaluate(cluster, pending, "native")
        timing["native"].append(time.perf_counter() - t_start)
        worst = max(worst, _price_tuples_close(dict(enumerate(main_out)),
                                               dict(enumerate(native))))
        priced += sum(v is not None for v in native)
    require(worst <= 1.0,
            f"K21's prices off the C++ engine's by {worst} of the "
            f"rel {PRICE_REL}, abs {PRICE_ABS} tolerance")
    require(priced > 0, "no candidate was priced")

    def ms(xs):
        return float(np.mean(xs) * 1e3) if xs else None

    emit("lookahead", card=card, envs=LOOKAHEAD_ENVS, steps=LOOKAHEAD_STEPS,
         wall_s=wall, env_s=out["timing"]["env_s"],
         decisions=len(main_s), k21_calls=len(calls),
         k21_launches=launches["lookahead"],
         price_tolerance_used=worst,
         pricing_ms_per_decision_main_path=ms(main_s),
         pricing_ms_per_k21_call={"jax_k21": ms(timing["jax"]),
                                  "native": ms(timing["native"])},
         candidates_per_k21_call=float(np.mean(
             [len(p) for _, p, _ in calls])),
         recorded_lane_ticks={g: info["ticks"]
                              for g, info in recorded_groups.items()},
         launches={k: v for k, v in launches.items() if v})
    return launches


def phase_checkpoints(card):
    """Phase 18: all six shipped checkpoints on the card, each on its own
    surface (``ddls_tpu_torch/data/checkpoint_<name>.npz``): the recorded
    JAX greedy decisions (actions equal, logits within 1e-4, masked ones
    the float32 floor) through K1-K4 and K17, which must have run on the
    8-, 72- and 128-server observations; ``ppo_device_trained``'s greedy
    episode from seed 7009 equal to FixedDegreePacking(8) at every step
    (more than 100 decisions), and its per-decision return from seed 7005
    above 0.2."""
    f32_min = np.finfo(np.float32).min
    report = {}
    for name in CHECKPOINT_NAMES:
        fx = load_checkpoint_fixture(name)
        rec = fx["recorded"]
        model = fx["model"].to("cuda").eval()
        env = RampJobPartitioningEnvironment(**fx["env_config"])
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        got = greedy_episode(model, env, fx["seed"],
                             max_decisions=len(rec["jax_actions"]))
        wall = time.monotonic() - t0
        launches = kernels.launch_counts()
        require(np.array_equal(got["actions"], rec["jax_actions"]),
                f"{name}: greedy actions differ from JAX's")
        masked = rec["jax_logits"] == f32_min
        require(np.array_equal(got["logits"] == f32_min, masked),
                f"{name}: masked logits differ")
        err = float(np.abs(got["logits"][~masked]
                           - rec["jax_logits"][~masked]).max())
        require(err <= 1e-4, f"{name}: logits off JAX's by {err}")
        for kname in ("ln_linear_act", "csr_segment_mean",
                      "masked_mean_pool_concat", "mask_logits_argmax",
                      "mlp_heads"):
            require(launches[kname] > 0, f"{name}: {kname} did not run")
        report[name] = {"decisions": len(got["actions"]),
                        "servers": fx["env_config"]["node_config"]["type_1"][
                            "num_nodes"],
                        "logits_max_abs_err": err,
                        "ms_per_decision": wall / len(got["actions"]) * 1e3}
    fx = load_checkpoint_fixture("ppo_device_trained")
    model = fx["model"].to("cuda").eval()
    packing = greedy_episode(
        model, RampJobPartitioningEnvironment(**fx["env_config"]), 7009,
        actor=FixedDegreePacking(8))
    require(len(packing["actions"]) > 100
            and np.array_equal(packing["actions"], packing["actor_actions"]),
            "ppo_device_trained is not FixedDegreePacking(8) over seed 7009")
    scored = greedy_episode(
        model, RampJobPartitioningEnvironment(**fx["env_config"]), 7005)
    per_decision = float(scored["rewards"].sum()
                         / max(len(scored["rewards"]), 1))
    require(per_decision > 0.2,
            f"ppo_device_trained per-decision return {per_decision}")
    emit("checkpoints", card=card, checkpoints=report,
         device_trained={"packing_decisions": len(packing["actions"]),
                         "per_decision_7005": per_decision,
                         "decisions_7005": len(scored["rewards"])})


# ------------------------------------------- the device episode replay
# K23-K25 and K21 (with skip): one launch each a decision, over all lanes
EPISODE_KERNELS = device_env_fixture.EPISODE_KERNELS
# the decisions whose kernel calls are held against the plain versions,
# and (K21's plain version takes ~50 launches a tick) those where K21 is
EPISODE_CHECKED = 16
EPISODE_LA_PLAIN = (0, 7, 15)
# t and jct of the float64 replays against the recorded x64 ones and the
# host env (tests/test_jax_episode.py's limit); the float32 replays are
# held bit for bit (their kernels repeat XLA's float32 arithmetic)
EPISODE_REL = 1e-9
_diff = device_env_fixture.max_difference


def _episode_bank(banks, lanes, dtype):
    return {name: torch.from_numpy(np.ascontiguousarray(banks[name][lanes]))
            .to("cuda", want or dtype) for name, want in
            device_env.BANK_FIELDS}


def check_episode_kernels(et, fx, dtype, lanes):
    """The first ``EPISODE_CHECKED`` decisions of the recorded banks
    ``lanes``, decision by decision: K23, K24 and K25 against their plain
    versions on each decision's own inputs, K21 (with ``skip``) at
    ``EPISODE_LA_PLAIN``. Returns the largest difference per kernel (0:
    bit-equal floats, equal integers) and the number of calls held."""
    ek = device_env.episode_kernels(et, device="cuda", dtype=dtype)
    bank = _episode_bank(fx["banks"], lanes, dtype)
    acts = torch.from_numpy(np.stack([fx["actions"]] * len(lanes))).to(
        "cuda", torch.int32)
    err, held, _ = device_env_fixture.episode_kernel_diffs(
        ek, bank, acts, EPISODE_CHECKED, EPISODE_LA_PLAIN)
    torch.cuda.synchronize()
    for name, value in err.items():
        require(value == 0, f"{name} differs from its plain version on the "
                            f"episode's calls ({dtype}): {value}")
    return err, held


def _replay(fn, banks, actions, lanes):
    bank = {k: v[lanes] for k, v in banks.items()}
    acts = np.stack([actions] * len(lanes))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(bank, acts)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _hold_replay(out, out_rows, want, rows, dtype, what):
    """Every decision's accept, cause and reward of lanes ``out_rows`` of
    a replay equal to rows ``rows`` of the recording (``want``: {"trace",
    "counters"}), t and jct bit-equal in float32 and within
    ``EPISODE_REL`` in float64, the counters equal. Returns the largest
    relative error of t and jct."""
    worst = 0.0
    for name, got in zip(device_env_fixture.TRACE_NAMES, out["trace"]):
        got = got.cpu().numpy()[out_rows]
        ref = want["trace"][name][rows]
        if name in ("t", "jct") and dtype == torch.float64:
            rel = float(np.max(np.abs(got - ref) /
                               np.maximum(np.abs(ref), 1e-300)))
            worst = max(worst, rel)
            require(rel <= EPISODE_REL, f"{what}: {name} off the recording "
                                        f"by rel {rel}")
        else:
            require(np.array_equal(got, ref), f"{what}: {name} differs from "
                                              f"the recording")
    for name, ref in want["counters"].items():
        got = out[name].cpu().numpy()[out_rows]
        ref = ref[rows]
        if name in ("ret", "t") and dtype == torch.float64:
            ok = np.allclose(got, ref, rtol=EPISODE_REL, atol=0)
        else:
            ok = np.array_equal(got, ref)
        require(ok, f"{what}: counter {name} {got} differs from the "
                    f"recording {ref}")
    return worst


def _profile_by_kernel(run, steps, names=kernels.KERNELS):
    """``run()`` under torch.profiler. Returns the device time of each
    CUDA kernel's launches in launch order ({function name: [ms, ...]})
    and the profile: the wall, the device ms and the busy share; a step's
    device ms and device operations (kernels, copies, fills); per step the
    device ms and launches of each of the kernels ``names`` that ran, and
    per launch their device ms; the rest's device ms and operations a
    step, and its eight costliest functions' ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    by_launch = {}
    for e in events:
        by_launch.setdefault(e.name, []).append(e.device_time_total / 1e3)
    mine, claimed = {}, set()
    for name in names:
        keys = [k for k in by_launch if re.search(rf"\b{name}_kernel\b", k)]
        if keys:
            mine[name] = [t for k in keys for t in by_launch[k]]
            claimed.update(keys)
    theirs = {k: v for k, v in by_launch.items() if k not in claimed}
    total = sum(sum(v) for v in by_launch.values())
    top = sorted(theirs.items(), key=lambda kv: -sum(kv[1]))[:8]
    return by_launch, {
        "wall_ms": wall_ms, "device_ms": total,
        "device_busy_share": total / wall_ms,
        "device_ms_per_step": total / steps,
        "device_ops_per_step": len(events) / steps,
        "kernel_device_ms_per_step": {k: sum(v) / steps
                                      for k, v in mine.items()},
        "kernel_launches_per_step": {k: len(v) / steps
                                     for k, v in mine.items()},
        "kernel_device_ms_per_launch": {k: sum(v) / len(v)
                                        for k, v in mine.items()},
        "other_device_ms_per_step": sum(sum(v) for v in theirs.values())
        / steps,
        "other_device_ops_per_step": sum(len(v) for v in theirs.values())
        / steps,
        "top_other_device_ms_per_step": {k[:60]: sum(v) / steps
                                         for k, v in top}}


def _profile_episode(et, fx, dtype, lanes):
    """The recorded banks ``lanes`` replayed twice, decision by decision as
    ``make_episode_fn`` runs them. The first run records what the bounds
    count: each decision's config rows, active lanes, K21 ticks, accepts
    and completions. The second, identical but for that recording, runs
    under torch.profiler: device time per kernel, the device operations
    (kernels, copies, fills) per decision, and the busy share
    (``_profile_by_kernel``'s, a step a decision)."""
    ek = device_env.episode_kernels(et, device="cuda", dtype=dtype)
    bank = _episode_bank(fx["banks"], lanes, dtype)
    acts = torch.from_numpy(np.stack([fx["actions"]] * len(lanes))).to(
        "cuda", torch.int32)
    D = acts.shape[1]

    def run(record):
        trace = {name: torch.zeros(acts.shape, dtype=want or dtype,
                                   device="cuda")
                 for name, want in device_env.TRACE_FIELDS}
        state = ek.init_state(bank, acts)
        for d in range(D):
            raw = ek.evaluate(state)
            if record is not None:
                record.append([state["cfg"].clone(), state["active"].clone(),
                               raw["ticks"].clone(),
                               state["completed"].clone()])
            device_env.episode_step(ek, state, bank, acts, raw, trace, d)
            if record is not None:
                record[-1] += [trace["accept"][:, d].clone(),
                               state["completed"].clone()]

    calls = []
    run(calls)
    _, prof = _profile_by_kernel(lambda: run(None), D, EPISODE_KERNELS)
    stacked = [torch.stack([c[i] for c in calls]).cpu().numpy()
               for i in range(6)]                                # [D, B]
    return {**prof, "decisions": D, "lanes": len(lanes), "cfg": stacked[0],
            "active": stacked[1], "ticks": stacked[2],
            "accept": stacked[4], "completions": stacked[5] - stacked[3]}


def _k23_work(et, cfg, active, fb, n_deg=None):
    """K23's least bytes and operations over calls of config rows ``cfg``
    [D, B] whose rows ``active`` [D, B] place a job: the config rows of
    each valid forward op (its sub-ops up to its split), and per launch
    each shape row the placing rows' ops use, with the anchors and cells
    of its shapes' origin spans; the row's state (memory and occupancy)
    and outputs. With ``n_deg`` (``price_all``'s indexed calls: each run
    of ``n_deg`` rows prices one lane) a pricing lane's state is read once
    for its rows, and the new memory is not counted: ``price_all`` reads
    only the placements and verdicts. Operations: one per cell test of
    each valid op's shape row at the anchors of each shape's origin
    span."""
    tb, pads = et.tables, et.pads
    F, P = pads.n_fwd, pads.n_parents
    S = et.n_srv
    st = et.st
    n_valid = tb["n_ops"][cfg]
    n_rows = st.row.shape[0]
    split_row = np.minimum(np.maximum(tb["f_split"], 0), n_rows - 1)
    f_bytes = (F + (tb["f_valid"] * (4 + fb + 4 * P + 8 * tb["f_split"]))
               .sum(1))
    shape_cells = (st.anchor_span[:, :, None]
                   & (st.anchor_cells != -2)).sum((1, 2))
    row_ids = [r[r >= 0] for r in st.row]
    row_bytes = np.array([4 * len(r) + len(r) * S
                          + 4 * int(shape_cells[r].sum()) for r in row_ids])
    row_tests = np.array([int(shape_cells[r].sum()) for r in row_ids])
    op_tests = (tb["f_valid"] * row_tests[split_row]).sum(1)
    rows_bytes = 0.0
    for d in range(cfg.shape[0]):
        used = np.unique(split_row[cfg[d]][
            tb["f_valid"][cfg[d]] & (active[d] > 0)[:, None]])
        rows_bytes += row_bytes[used].sum()
    nbytes = rows_bytes + float(np.sum(active * (
        4 + f_bytes[cfg] + 4 * n_valid + 1)))
    if n_deg is None:
        state = float(np.sum(active)) * (S * (fb + 1) + S * fb)
    else:
        lanes = active.reshape(cfg.shape[0], -1, n_deg).max(2)
        state = float(np.sum(lanes)) * S * (fb + 1)
    return nbytes + state, float(np.sum(active * op_tests[cfg]))


def _episode_bounds(et, prof, dtype):
    """Per call of each kernel on the profiled replay, the least bytes and
    operations the call's work needs, as ``bound_ms`` of each. A config
    row's valid masks count in full; its other fields count per valid op,
    dep, group edge, sync pair and one-to-one edge of the lane's config;
    K23, K24 and K21 count only the lanes that decide (the others' outputs
    are not read); K25 counts every lane's state and trace, the decision's
    inputs of the deciding lanes, the slot an accept writes and the slots
    each completion frees. K25's occupancy indices (a slot number per
    server and channel of a committed or freed slot) are left out, so its
    bound is low rather than high. Operations: K23 one per cell test of
    each valid op's shape row at the anchors of each shape's origin span;
    K24 the sort's m log2 m comparisons, the op ranks' n^2, one per priced
    group edge, sync pair and one-to-one edge; K21 one per valid op and
    dep a tick of the ticks this run took; K25 one per valid dep and op of
    a deciding lane and per server and channel of a committed or freed
    slot."""
    tb, pads = et.tables, et.pads
    fb = 4 if dtype == torch.float32 else 8
    N, M = pads.n_ops, pads.n_deps
    G, Eg, Sy, O = pads.n_groups, pads.group_edges, pads.n_sync, pads.n_o2o
    S, C, R = et.n_srv, et.n_chan, et.n_srv
    cfg, active = prof["cfg"], prof["active"].astype(np.float64)
    ticks, accept = prof["ticks"], prof["accept"].astype(np.float64)
    completions = prof["completions"].astype(np.float64)
    D, B = cfg.shape
    n_valid = tb["n_ops"][cfg]
    m_valid = tb["n_deps"][cfg]
    k23_bytes, k23_ops = _k23_work(et, cfg, active, fb)
    # K24: the lane's config rows and the priced edges, the pair channels
    # once a launch, the outputs of the valid deps and ops
    n_grp = tb["grp_valid"].sum(1)
    n_gedge = tb["grp_edge_valid"].sum((1, 2))
    n_sync = tb["sync_valid"].sum(1)
    n_o2o = tb["o2o_valid"].sum(1)
    k24_lane = (12 + N + M + G + Sy + O + n_grp * (Eg + fb) + n_gedge * 12
                + n_sync * (16 + fb) + n_o2o * 4)[cfg]
    k24_bytes = float(np.sum(active * (
        k24_lane + n_valid * (4 + fb + 8 + fb)
        + m_valid * (12 + fb + fb + 1 + 4 + fb) + 1))) + D * S * S * 4
    k24_ops = float(np.sum(active * (
        m_valid * np.ceil(np.log2(np.maximum(m_valid, 2)))
        + n_valid.astype(np.float64) ** 2
        + (n_gedge + n_sync + n_o2o)[cfg])))
    # K25: every lane's scalar state (read and written), trace row, next
    # action and bank row, slot table; a deciding lane's kernel outputs;
    # an accept's slot and memory; each completion's slot and memory
    scalars = 2 * (3 * fb + 30) + (3 * fb + 6) + 12 + 2 * fb + R * (1 + fb)
    # (the flags and channels, ops and servers of the valid prefixes:
    # K24 writes no flow past them)
    deciding = (5 * m_valid + 5 * n_valid + S * fb + 2 * fb + 7
                + 4 * np.minimum(m_valid, C))
    slot = S * fb + S + C
    k25_bytes = float(np.sum(scalars + active * deciding
                             + accept * (slot + 2 * S * fb + 1 + fb)
                             + completions * slot
                             + (completions > 0) * 2 * S * fb))
    k25_ops = float(np.sum(active * (m_valid + n_valid)
                           + (accept + completions) * (S + C)))
    # K21: the valid masks in full, the valid slots' other fields, the
    # outputs, for the lanes that tick
    la_bytes = float(np.sum(active * (N + M + n_valid * (2 * fb + 8)
                                      + m_valid * (2 * fb + 14)
                                      + 4 * fb + 5)))
    la_ops = float(np.sum(active * ticks * (n_valid + m_valid)))
    out = {}
    for name, nbytes, ops in (("allocate_job", k23_bytes, k23_ops),
                              ("price_and_score", k24_bytes, k24_ops),
                              ("lookahead", la_bytes, la_ops),
                              ("episode_step", k25_bytes, k25_ops)):
        b, by = bound_ms(nbytes, ops)
        out[name] = (b / D, by, nbytes / D, ops / D)
    return out


def _host_episode(card):
    """(b): the port's own host env on the shipped surface (candidate
    pricing off: it feeds only the observation, which the replay does not
    read), the reference test's mixed-action policy from seed 17 / rng 23;
    the free grid of each decision recorded for K22."""
    from ddls_tpu_torch.agents.block_search import snapshot_free_servers
    from ddls_tpu_torch.sim.device_block_search import free_grid_from_ramp

    env_cfg = dict(load_checkpoint_fixture("ppo_price_mixed")["env_config"],
                   candidate_pricing=None, obs_include_candidate_prices=False)
    env = RampJobPartitioningEnvironment(**env_cfg)
    grids = []

    def before(env, job_idx):
        grids.append(free_grid_from_ramp(
            snapshot_free_servers(env.cluster), env.cluster.topology.shape,
            job_idx))

    t0 = time.monotonic()
    arrivals, decisions, stats = device_env_fixture.mixed_action_episode(
        env, before_step=before)
    host_s = time.monotonic() - t0
    et, rel, causes = _hold_host_episode(env, arrivals, decisions, stats)
    emit("episode_host_env", card=card, decisions=len(decisions),
         host_episode_s=host_s, t_jct_max_rel_err=rel, causes=causes,
         **stats)
    return np.stack(grids), et


def _hold_host_episode(env, arrivals, decisions, stats):
    """A host env's episode (``mixed_action_episode``'s outputs) replayed
    on the card in float64 from a bank of its arrivals: every decision's
    reward, accept and cause equal, t and jct within ``EPISODE_REL``, the
    episode's counts equal. Returns the tables, the largest relative
    error and the count of each cause."""
    et = device_env.build_episode_tables(env)
    bank = device_env.build_job_bank(et, arrivals)
    actions = np.array([d[0] for d in decisions], np.int32)
    fn = device_env.make_episode_fn(et, device="cuda", dtype=torch.float64)
    out = fn(bank, actions)
    trace = {name: x.cpu().numpy() for name, x in
             zip(device_env_fixture.TRACE_NAMES, out["trace"])}
    host = np.array([d[1:] for d in decisions], np.float64)
    require(trace["has_job"].all(), "the replay ran out of queued jobs "
                                    "before the host env did")
    require(np.array_equal(trace["reward"], host[:, 0]) and
            np.array_equal(trace["accept"], host[:, 1] > 0) and
            np.array_equal(trace["cause"], host[:, 2]),
            "the float64 replay decides otherwise than the host env")
    accepted = (host[:, 1] > 0) & np.isfinite(host[:, 4])
    rel = max(float(np.max(np.abs(trace["t"] - host[:, 3]) /
                           np.maximum(np.abs(host[:, 3]), 1.0))),
              float(np.max(np.abs(trace["jct"][accepted] -
                                  host[accepted, 4]) /
                           host[accepted, 4])) if accepted.any() else 0.0)
    require(rel <= EPISODE_REL, f"the replay's t / jct off the host env's "
                                f"by rel {rel}")
    for key in ("arrived", "blocked_total", "completed"):
        require(int(out[key]) == stats[key], f"the replay's {key} "
                                             f"{int(out[key])} differs from "
                                             f"the host env's {stats[key]}")
    causes = {int(c): int(n) for c, n in zip(*np.unique(
        trace["cause"], return_counts=True))}
    return et, rel, causes


def _first_fit_tests(grids, shapes, meta) -> int:
    """The cell tests a first fit of ``shapes`` needs on the free grids
    ``grids`` [G, C, R, S]: in first-fit order (shape, then lexicographic
    origin), each anchor of each shape whose extents fit ``meta`` tests
    its window's cells up to the first taken one, until the first anchor
    that fits. A diagonal's window is empty (the reference's), so its
    anchor tests its own cell; a shape that does not fit costs nothing."""
    n_grids, C, R, S = grids.shape
    tests, fits = [], []
    for shape in shapes:
        if not all(m >= s for m, s in zip(meta, shape)):
            continue
        window = [(dc, dr, ds) for dc in range(shape[0])
                  for dr in range(shape[1]) for ds in range(shape[2])]
        window = window or [(0, 0, 0)]
        span = [min(max(m - s + 1, 0), n)
                for m, s, n in zip(meta, shape, (C, R, S))]
        for i in range(span[0]):
            for j in range(span[1]):
                for k in range(span[2]):
                    cells = np.stack([grids[:, (i + dc) % C, (j + dr) % R,
                                            (k + ds) % S]
                                      for dc, dr, ds in window], 1)
                    taken = ~cells
                    fits.append(~taken.any(1))
                    tests.append(np.where(taken.any(1),
                                          taken.argmax(1) + 1, len(window)))
    if not tests:
        return 0
    tests, fits = np.stack(tests, 1), np.stack(fits, 1)
    last = np.where(fits.any(1), fits.argmax(1), fits.shape[1] - 1)
    return int(np.take_along_axis(np.cumsum(tests, 1), last[:, None],
                                  1).sum())


def phase_block_search(grids, et, card):
    """K22 over the free grids of the host episode's decisions, one batch
    per split value's shape list (the launch counters reset just before
    and read just after): equal to its plain version, and on the regular
    shapes (the reference's primitive leaves diagonals to the placer) to
    the host's C++ first fit, block for block."""
    from ddls_tpu_torch.agents.block_search import (block_shapes_for,
                                                    factor_pairs)
    from ddls_tpu_torch.native import run_first_fit_block
    from ddls_tpu_torch.sim.device_block_search import (block_cells,
                                                        first_fit_block,
                                                        first_fit_block_plain)

    ramp = tuple(et.st.ramp_shape)
    free = torch.from_numpy(grids).cuda()
    splits = [d for d in et.degrees]
    shape_lists = []
    for split in splits:
        shapes = block_shapes_for(factor_pairs(split), ramp)
        shape_lists.append(shapes + [(split, split, -1), (split, 1, 1)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    found = [first_fit_block(free, shapes, ramp) for shapes in shape_lists]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    require(launches["first_fit_block"] == len(splits),
            "the block search did not launch K22 once a split")
    err = 0.0
    host_checked = 0
    for shapes, got in zip(shape_lists, found):
        want = first_fit_block_plain(free, shapes, ramp)
        err = max(err, *(_diff(g, w) for g, w in zip(got, want)))
        regular = [s for s in shapes if s[2] != -1]
        reg = [x.cpu().numpy() for x in first_fit_block(free, regular,
                                                        ramp)]
        for g in range(len(grids)):
            host = run_first_fit_block(
                regular, ramp, ramp, np.zeros(grids[g].size),
                (~grids[g]).reshape(-1).astype(np.uint8), None, False)
            require((host is not None) == bool(reg[4][g]),
                    "K22 and the host's first fit disagree on a fit")
            if host is not None:
                cells = block_cells(regular[int(reg[0][g])],
                                    (int(reg[1][g]), int(reg[2][g]),
                                     int(reg[3][g])), ramp)
                require([tuple(c) for c in host[0]] == cells,
                        "K22 found another block than the host's first fit")
            host_checked += 1
    require(err == 0, f"K22 differs from its plain version: {err}")
    shapes_16 = shape_lists[-1]
    nbytes = grids.size + 12 * len(shapes_16) + len(grids) * 17
    ops = _first_fit_tests(grids, shapes_16, ramp)
    bound, bound_by = bound_ms(nbytes, ops)
    res = _new_result(
        max_abs_err=err, bound_ms=bound, bound_by=bound_by,
        ms=device_ms(lambda: first_fit_block(free, shapes_16, ramp)),
        eager_ms=eager_ms(lambda: first_fit_block(free, shapes_16, ramp)),
        plain_ms=eager_ms(lambda: first_fit_block_plain(free, shapes_16,
                                                        ramp), iters=5),
        shape=(f"grids={len(grids)} ramp={list(ramp)} shapes="
               f"{len(shapes_16)} (split {splits[-1]})"),
        calls_per_step=len(splits))
    emit("block_search", card=card, grids=len(grids), splits=splits,
         k22_launches=launches["first_fit_block"],
         host_first_fit_checked=host_checked, max_abs_err=err,
         ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=bound)
    return {"first_fit_block": res}, launches


def phase_episode(card):
    """Phase 19: the device episode replay at full width on the shipped
    surface (``ddls_tpu_torch/data/device_env_replay.npz``): (a) the
    recorded JAX replays of eight banks (float32) and bank 0 (x64) at 1
    lane and at 8 lanes, the 8-lane float32 replay the counted main path;
    every decision and counter against the recording; each kernel call of
    the first decisions against its plain version; (b) the port's host
    env's own episode replayed in float64, decision for decision; K22 over
    its grids; (c) decisions/s at 1 and 8 lanes, the device time per
    decision by kernel, launches per decision, K21's ticks per decision
    and the device busy share under torch.profiler."""
    fx = device_env_fixture.load_device_env_fixture()
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    require(et.types == fx["types"], "the shipped surface's model types "
                                     "differ from the recording's")
    banks, actions = fx["banks"], fx["actions"]
    lanes8 = list(range(8))
    info = {}
    for dtype, key in ((torch.float32, "f32"), (torch.float64, "x64")):
        fn = device_env.make_episode_fn(et, device="cuda", dtype=dtype)
        recorded = list(range(fx[key]["trace"]["cause"].shape[0]))
        _replay(fn, banks, actions[:4], [0])        # first use, not timed
        worst, one_lane_s = 0.0, []
        for lane in recorded:
            out, wall = _replay(fn, banks, actions, [lane])
            one_lane_s.append(wall)
            worst = max(worst, _hold_replay(out, [0], fx[key], [lane],
                                            dtype, f"{key} bank {lane}, "
                                                   "1 lane"))
        if dtype == torch.float32:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
        out8, wall8 = _replay(fn, banks, actions, lanes8)
        if dtype == torch.float32:
            launches = kernels.launch_counts()
            for name in EPISODE_KERNELS:
                require(launches[name] == len(actions),
                        f"{name} launched {launches[name]} times in "
                        f"{len(actions)} decisions of the 8-lane replay")
        worst = max(worst, _hold_replay(out8, recorded, fx[key], recorded,
                                        dtype, f"{key}, 8 lanes"))
        if dtype == torch.float64:
            # the other lanes: each equal to that bank replayed alone
            for lane in lanes8[1:]:
                alone, _ = _replay(fn, banks, actions, [lane])
                for s, a in zip(out8["trace"], alone["trace"]):
                    require(torch.equal(s[lane], a[0]),
                            f"x64 lane {lane} of 8 differs from its bank "
                            f"replayed alone")
        n_dec = int(out8["trace"][5].sum())
        info[key] = {
            "decisions_per_s_1_lane": len(actions) / float(np.mean(
                one_lane_s)),
            "decisions_per_s_8_lanes": n_dec / wall8,
            "episode_s_1_lane": float(np.mean(one_lane_s)),
            "episode_s_8_lanes": wall8,
            "t_jct_max_rel_err": worst,
            "accepted": out8["accepted"].tolist(),
            "k21_ticks_per_lane_decision": float(
                out8["lookahead_ticks"].sum()) / n_dec}
    emit("episode", card=card, **info,
         launches={k: v for k, v in launches.items() if v},
         launches_per_decision={k: launches[k] / len(actions)
                                for k in EPISODE_KERNELS})

    results = {}
    for dtype, lanes in ((torch.float32, lanes8), (torch.float64, [0])):
        err, held = check_episode_kernels(et, fx, dtype, lanes)
        for name in EPISODE_KERNELS:
            results.setdefault(name, _new_result(calls_per_step=1))
            results[name]["max_abs_err"] = max(
                results[name]["max_abs_err"], err[name])
            results[name].setdefault("held_calls", 0)
            results[name]["held_calls"] += held[name]

    prof = _profile_episode(et, fx, torch.float32, lanes8)
    bounds = _episode_bounds(et, prof, torch.float32)
    D = prof["decisions"]
    ek = device_env.episode_kernels(et, device="cuda", dtype=torch.float32)
    dev = ek.dev
    bank = _episode_bank(banks, lanes8, torch.float32)
    acts = torch.from_numpy(np.stack([actions] * 8)).to("cuda", torch.int32)
    state = ek.init_state(bank, acts)
    raw = ek.evaluate(state)
    la_skip = ~state["active"]
    trace = {name: torch.zeros(acts.shape, dtype=want or torch.float32,
                               device="cuda")
             for name, want in device_env.TRACE_FIELDS}

    def step_plain():
        s2 = {k: v.clone() for k, v in state.items()}
        device_env.episode_step_plain(ek, s2, bank, acts, raw, trace, 0)

    plain = {
        "allocate_job": lambda: device_env.allocate_job_plain(
            state["mem"], state["srv_job"] < 0, state["cfg"], dev),
        "price_and_score": lambda: device_env.price_and_score_plain(
            raw["ots"], state["cfg"], dev),
        "lookahead": lambda: _k21_indexed_plain(raw, state["cfg"], la_skip,
                                                dev),
        "episode_step": step_plain}
    free0 = state["srv_job"] < 0
    eager = {
        "allocate_job": eager_ms(lambda: device_env.allocate_job(
            state["mem"], free0, state["cfg"], dev)),
        "price_and_score": eager_ms(lambda: device_env.price_and_score(
            raw["ots"], state["cfg"], dev)),
        "lookahead": eager_ms(lambda: _k21_indexed(
            raw, state["cfg"], la_skip, dev), iters=20)}
    clones = [{k: v.clone() for k, v in state.items()} for _ in range(20)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in clones:
        device_env.episode_step(ek, s, bank, acts, raw, trace, 0)
    end.record()
    end.synchronize()
    eager["episode_step"] = start.elapsed_time(end) / len(clones)
    # K23's forms on the same call: the shared form (the surface's own)
    # against the tables read from global memory
    k23_call = (lambda: device_env.allocate_job(state["mem"], free0,
                                                state["cfg"], dev))
    results["allocate_job"]["forms_device_ms"] = {
        "shared": device_ms(k23_call),
        "global_tables": forced_ms("allocate_job", 1, k23_call),
        "shared_again": device_ms(k23_call)}
    for name in EPISODE_KERNELS:
        r = results[name]
        r.update(ms=prof["kernel_device_ms_per_step"][name],
                 eager_ms=eager[name], bound_ms=bounds[name][0],
                 bound_by=bounds[name][1],
                 plain_ms=eager_ms(plain[name],
                                   iters=1 if name == "lookahead" else 3),
                 shape=(f"episode: lanes=8 decisions={D} N={et.pads.n_ops} "
                        f"M={et.pads.n_deps} configs={dev.n_cfg} "
                        f"servers={et.n_srv} channels={et.n_chan} float32"))
    emit("episode_profile", card=card, decisions=D, lanes=8,
         wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
         device_busy_share=prof["device_busy_share"],
         device_ms_per_decision=prof["kernel_device_ms_per_step"],
         other_device_ms_per_decision=prof["other_device_ms_per_step"],
         k21_ticks_per_lane_decision=float(prof["ticks"].sum()) / (
             D * prof["lanes"]),
         k21_slowest_lane_ticks_per_decision=float(
             prof["ticks"].max(1).mean()),
         device_ops_per_decision=prof["device_ops_per_step"],
         kernel_launches_per_decision=prof["kernel_launches_per_step"],
         other_device_ops_per_decision=prof["other_device_ops_per_step"],
         top_other_device_ms_per_decision=prof[
             "top_other_device_ms_per_step"],
         bound_ms_per_call={k: v[0] for k, v in bounds.items()},
         bound_bytes_per_call={k: v[2] for k, v in bounds.items()},
         bound_ops_per_call={k: v[3] for k, v in bounds.items()})

    grids, host_et = _host_episode(card)
    bs_results, bs_launches = phase_block_search(grids, host_et, card)
    results.update(bs_results)
    return results, launches, bs_launches


# ----------------------------------------- device collection (PR 9 slice)
# the kernels a collection step launches besides the replay's: K26, K25's
# prepare, K27, K28 and K25 (with the reset)
SEGMENT_KERNELS = device_env_fixture.SEGMENT_KERNELS
# the steps of the first recorded collect whose kernel calls are held
# against the plain versions (float32 and float64)
COLLECT_CHECKED = 16
DEVICE_CONFIG_PATH = os.path.join(REPO, "ddls_tpu_torch", "data",
                                  "train_config_ppo_device_load32.json")


def _collect_surface():
    """env_load32 as the device-collection config composes it (reset from
    seed 0, as the loop's template env), its tables, and
    ppo_device_trained on the card."""
    with open(DEVICE_CONFIG_PATH) as fh:
        cfg = json.load(fh)
    env = RampJobPartitioningEnvironment(**copy.deepcopy(cfg["env_config"]))
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    model = load_checkpoint_fixture("ppo_device_trained")["model"]
    return et, ot, model.to("cuda").eval()


def _same_collect(a, b):
    def flat(out):
        return ([out["traj"][k] for k in ("actions", "logp", "values",
                                          "rewards", "dones")]
                + [out["traj"]["obs"][k] for k in sorted(out["traj"]["obs"])]
                + [out["trace"][k] for k in sorted(out["trace"])
                   if not k.startswith("memo_")] + [out["last_values"]])
    return all(np.array_equal(x, y) for x, y in zip(flat(a), flat(b)))


def _segment_bounds(et, tr):
    """Per call of each collection kernel on a collect's trace ([T, B]
    host arrays, the memo on), the least bytes and operations: K26 a
    row's fields, its static graph-feature row, the rebuilt row and mask;
    K25's prepare a lane's queue state, type, action, degree column and
    config row; K27, for the lanes that evaluate, the key (the ops' server
    codes and valid mask, the times' words), the hash weights, the groups
    written, and the stored key a hit compares in full (a miss needs one
    word a way; ``memo_hits_before``: each lane's hits before the
    collect); K28 a deciding lane's results and, on a miss, the key it
    writes; K25 every lane's scalar state, trace and fields, a deciding
    lane's kernel outputs, an accept's slot, a completion's slot, and the
    fresh state a reset writes. Operations: the hash's two a word and the
    compare's one a word; K25's per valid op and dep and per server and
    channel of a committed, freed or reset slot."""
    tb, pads = et.tables, et.pads
    fb = 4
    N, M = pads.n_ops, pads.n_deps
    S, C, R = et.n_srv, et.n_chan, et.n_srv
    A = et.max_action + 1
    T, B = tr["action"].shape
    deg_col = np.full(max(et.max_action, max(et.degrees)) + 1, -1)
    for i, d in enumerate(et.degrees):
        deg_col[d] = i
    col = deg_col[np.clip(tr["action"], 0, len(deg_col) - 1)]
    active = ((tr["action"] > 0) & (col >= 0)).astype(np.float64)
    cfg = np.clip(tr["jtype"] * len(et.degrees) + col, 0,
                  len(tb["n_ops"]) - 1)
    n_valid = tb["n_ops"][cfg].astype(np.float64)
    m_valid = tb["n_deps"][cfg].astype(np.float64)
    hits = np.diff(np.concatenate([tr["memo_hits_before"][None],
                                   tr["memo_hits"]]), axis=0)
    miss = active - hits
    words = 1 + N + M
    accept = tr["accept"].astype(np.float64)
    done = tr["done"].astype(np.float64)
    prev = np.concatenate([np.zeros((1, B)), tr["ep_completed"][:-1]])
    prev = np.where(np.concatenate([np.zeros((1, B), bool),
                                    tr["done"][:-1]]), 0, prev)
    completions = np.maximum(tr["ep_completed"] - prev, 0)
    k26 = B * (16 + 2 * fb + (17 + A) * 4 + 8 + (17 + A) * 4 + A * 4)
    prep = B * 22
    k27 = float(np.sum(active * (N * 5 + M * 4 + words * 4 + N * 4 + 20
                                 + hits * words * 4 + miss * 4 * 2)))
    k27_ops = float(np.sum(active * (2 * words + hits * words)))
    k28 = float(np.sum(active * 24 + miss * (words * 4 + (N + M) * 4)))
    scalars = 2 * (3 * fb + 30) + (3 * fb + 6) + 12 + 2 * fb + R * (1 + fb)
    # (the flags and channels, ops and servers of the valid prefixes:
    # K24 writes no flow past them)
    deciding = (5 * m_valid + 5 * n_valid + S * fb + 2 * fb + 7
                + 4 * np.minimum(m_valid, C))
    slot = S * fb + S + C
    fresh = S * (fb + 4) + C * 4 + R * (1 + fb) + R * S * (fb + 1) + R * C
    k25 = float(np.sum(scalars + 40 + active * deciding
                       + accept * (slot + 2 * S * fb + 1 + fb)
                       + completions * slot + done * fresh))
    k25_ops = float(np.sum(active * (m_valid + n_valid)
                           + (accept + completions) * (S + C)
                           + done * (S + C + R * (S + C))))
    out = {}
    for name, nbytes, ops in (("kernel_obs", T * k26, T * B * 12.0),
                              ("episode_prepare", T * prep, T * B * 6.0),
                              ("memo_probe", k27, k27_ops),
                              ("memo_insert", k28, float(np.sum(active))),
                              ("episode_step", k25, k25_ops)):
        b, by = bound_ms(nbytes, ops)
        out[name] = (b / T, by, nbytes / T, ops / T)
    return out


def _profile_collect(col, generator):
    """One collect of a warmed collector under ``_profile_by_kernel``
    (every kernel, the forward included; a step a collect step), and the
    collect's output, its trace with each lane's memo hits before it."""
    hits0 = col.state["memo"]["hits"].cpu().numpy().copy()
    box = {}
    _, prof = _profile_by_kernel(
        lambda: box.update(out=col.collect(generator=generator)),
        col.rollout_length)
    box["out"]["trace"]["memo_hits_before"] = hits0
    return box["out"], prof


def _collect_kernel_times(et, ot, model, fx):
    """Each collection kernel timed on a call of the first recorded
    collect's first step (memo on, float32): eager ms between CUDA events
    and the plain version's ms, on the same inputs."""
    from ddls_tpu_torch.models.policy import mask_sample_logp
    from ddls_tpu_torch.sim import device_memo

    ek = device_env.episode_kernels(et, device="cuda", dtype=torch.float32)
    dev = ek.dev
    dobs = device_env.device_obs(ot, dev)
    rec = fx["collects"][0]
    b = device_env.device_bank(fx["banks"], dev)
    lanes = b["type"].shape[0]
    state = ek.init_state(b)
    memo = device_memo.memo_init(lanes, dev.pads.n_ops, dev.pads.n_deps,
                                 torch.float32, device_memo.MemoConfig(),
                                 dev.device)
    fields = device_env.obs_fields(state, b)
    f = [fields[name] for name, _ in device_env.OBS_FIELDS]
    gf, mask = device_env.kernel_obs(dobs, *f)
    logits, _ = model.trunk(dobs.forward_batch(f[0], gf, mask))
    u = torch.from_numpy(rec["uniforms"][:, 0]).cuda()
    action, _ = mask_sample_logp(logits, mask, u)
    device_env.episode_prepare(ek, state, b, action)
    cfg, active = state["cfg"], state["active"]
    ots = device_env.allocate_job(state["mem"], state["srv_job"] < 0, cfg,
                                  dev)[0]
    times = device_env.price_and_score(ots, cfg, dev)[0]
    op_valid = dev.t["op_valid"]
    probe = device_memo.memo_probe(memo, cfg, active, ots, op_valid, times,
                                   et.n_srv)
    t_c = torch.ones(lanes, dtype=torch.float32, device="cuda")
    ok_c = torch.ones(lanes, dtype=torch.bool, device="cuda")
    raw = ek.evaluate(state)
    trace = {name: torch.zeros((lanes, 8), dtype=want or torch.float32,
                               device="cuda")
             for name, want in device_env.TRACE_FIELDS
             + device_env.SEGMENT_TRACE_FIELDS}
    seg_trace = {k: trace[k] for k, _ in device_env.SEGMENT_TRACE_FIELDS}
    flds = {name: torch.zeros((lanes, 9), dtype=want or torch.float32,
                              device="cuda")
            for name, want in device_env.OBS_FIELDS}

    # the insert rewrites the probed way each call (the same work a miss
    # does), on its own copy of the table; K25 advances the state, so each
    # of its timed calls takes a fresh copy made before the timing
    tables = {plain: {k: v.clone() for k, v in memo.items()}
              for plain in (False, True)}

    def insert(plain):
        fn = (device_memo.memo_insert_plain if plain
              else device_memo.memo_insert)
        fn(tables[plain], probe, cfg, active, times, t_c, ok_c)

    def step_plain():
        s = {k: v.clone() for k, v in state.items()}
        device_env.episode_step_plain(ek, s, b, None, raw, trace, 0,
                                      seg_trace=seg_trace, fields=flds,
                                      reset=True)

    def prepare_plain():
        ek.prepare({k: v.clone() for k, v in state.items()}, b, action)

    calls = {
        "kernel_obs": (lambda: device_env.kernel_obs(dobs, *f),
                       lambda: device_env.kernel_obs_plain(dobs, *f)),
        "episode_prepare": (lambda: device_env.episode_prepare(
            ek, state, b, action), prepare_plain),
        "memo_probe": (lambda: device_memo.memo_probe(
            memo, cfg, active, ots, op_valid, times, et.n_srv),
            lambda: device_memo.memo_probe_plain(
                memo, cfg, active, ots, op_valid, times, et.n_srv)),
        "memo_insert": (lambda: insert(False), lambda: insert(True))}
    out = {}
    for name, (kernel, plain) in calls.items():
        out[name] = {"eager_ms": eager_ms(kernel, iters=50),
                     "plain_ms": eager_ms(plain, iters=5)}
    clones = [{k: v.clone() for k, v in state.items()} for _ in range(20)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in clones:
        device_env.episode_step(ek, s, b, None, raw, trace, 0,
                                seg_trace=seg_trace, fields=flds, reset=True)
    end.record()
    end.synchronize()
    out["episode_step"] = {"eager_ms": start.elapsed_time(end) / len(clones),
                           "plain_ms": eager_ms(step_plain, iters=5)}
    return out


def _hold_reset(et, ot, model, banks, col, traces, recorded):
    """[device_collect] (d), the in-kernel reset at full width. From the
    memo-on collector ``col`` after the recorded collects (their traces
    ``traces``), the recorded JAX collect that crosses both lanes' first
    reset (``recorded``), held against the recording as the recorded
    collects are, and required to end an episode. Over that collect, from
    the state before it: every call of K26, K25's prepare, K27, K28 and K25
    with the reset held against its plain version in float32 (where a lane
    ends, K25 rewrites its whole state: 32 slots x (32 + 32 + 992) entries
    and the scalars) and the held segment's trace equal to the collect's;
    the collect's episode records equal to those built from the steps
    alone; after each lane's first end, its steps equal to a fresh
    collector's first steps under the same uniforms. Returns the calls held
    per kernel, the K25 calls held where a lane reset, and a summary."""
    from ddls_tpu_torch.rl.ppo_device import DevicePPOCollector

    fxm = device_env_fixture
    T = col.rollout_length
    start = {part: {k: v.clone() for k, v in col.state[part].items()}
             for part in ("env", "memo")}
    u = recorded["uniforms"]
    out = col.collect(uniforms=u)
    faults, _ = fxm.hold_collect(out, recorded)
    require(not faults, f"the collect across the reset differs from the "
                        f"recording: {faults}")
    traces = [*traces, out["trace"]]
    done = out["trace"]["done"]
    require(done.any(), f"the recorded collect after {len(traces) - 1} "
                        f"collects of {T} steps ends no episode")
    diffs, held, tr = fxm.segment_kernel_diffs(
        et, ot, model, banks, u, T, device="cuda", dtype=torch.float32,
        start=start)
    torch.cuda.synchronize()
    for name, value in diffs.items():
        require(value == 0, f"{name} differs from its plain version on the "
                            f"collect with a reset: {value}")
    tr = {k: v.cpu().numpy().T for k, v in tr.items()}
    differ = [k for k in fxm.COLLECT_EXACT_KEYS + fxm.DECISION_KEYS
              if not np.array_equal(tr[k], out["trace"][k], equal_nan=True)]
    require(not differ, f"the held segment differs from the collect with "
                        f"a reset: {differ}")
    records, faults = fxm.ended_episode_records(traces)
    require(not faults, f"the episode counters disagree with the steps: "
                        f"{faults}")
    require(records == out["episodes"], "the collect's episode records "
                                        "differ from the steps'")
    ends, restart_u = fxm.restart_uniforms(u, done)
    fresh = DevicePPOCollector(et, ot, model, banks, T, device="cuda")
    compared, faults = fxm.restart_faults(
        out["trace"], fresh.collect(uniforms=restart_u)["trace"], ends)
    require(not faults and compared > 0,
            f"after the reset the lanes differ from a fresh collector "
            f"({compared} steps compared): {faults}")
    return held, int(done.any(1).sum()), {
        "collect": len(traces), "steps_before": (len(traces) - 1) * T,
        "end_steps": ends.tolist(), "resets": int(done.sum()),
        "reset_calls_held": int(done.any(1).sum()),
        "episodes": out["episodes"], "restart_steps_compared": compared}


def phase_device_collect(card):
    """[device_collect], the slice's path at full width (env_load32, 45
    configs, N 480, M 13,072, 32 servers, 992 channels; ppo_device_trained;
    2 lanes of stacked_job_banks(seed_base=0), float32): (a) the recorded
    JAX collects (3 x 128 steps, the reference collector with the memo off,
    its uniforms) reproduced with the memo off; (b) the same collects with
    the memo on (the launch counters reset just before, read just after),
    bit-equal to (a), its hit rate; each collection kernel's calls over the
    first 16 steps held against its plain version in float32 and float64;
    (d) the in-kernel reset at full width: the memo-on collector takes the
    recorded collect that crosses both lanes' first reset, over which every
    call is held again, the episode records and the restart checked
    (``_hold_reset``); (c) a collect from the generator timed, and one
    under torch.profiler: device ms a step by kernel, launches a step, the
    busy share."""
    from ddls_tpu_torch.rl.ppo_device import DevicePPOCollector
    from ddls_tpu_torch.sim.device_memo import MemoConfig

    fx = device_env_fixture.load_device_collect_fixture()["full"]
    et, ot, model = _collect_surface()
    require(et.types == fx["types"], "the surface's model types differ "
                                     "from the recording's")
    T = fx["collects"][0]["uniforms"].shape[1]
    runs, launches, counters = {}, None, None
    for memo in (False, True):
        col = DevicePPOCollector(et, ot, model, fx["banks"], T,
                                 memo_cfg=MemoConfig() if memo else None,
                                 device="cuda")
        torch.cuda.synchronize()
        if memo:
            kernels.reset_launch_counts()
        t0 = time.monotonic()
        outs = [col.collect(uniforms=r["uniforms"])
                for r in fx["collects"]]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if memo:
            launches = kernels.launch_counts()
            counters = col.memo_counters()
            memo_col = col
        runs[memo] = (outs, wall)
    errs = []
    for c, (out, r) in enumerate(zip(runs[False][0], fx["collects"])):
        faults, e = device_env_fixture.hold_collect(out, r)
        require(not faults, f"collect {c} (memo off) differs from the "
                            f"recording: {faults}")
        errs.append(e)
    for c, (on, off) in enumerate(zip(runs[True][0], runs[False][0])):
        require(_same_collect(on, off), f"collect {c}: the memo changed the "
                                        "results")
    steps = T * len(fx["collects"])
    for name in (*SEGMENT_KERNELS, "allocate_job", "price_and_score",
                 "lookahead", "minibatch_gather", "mask_sample_logp",
                 "mlp_heads", "ln_linear_act", "csr_segment_mean",
                 "masked_mean_pool_concat"):
        require(launches[name] > 0, f"the collection did not launch {name}")
    for name in ("kernel_obs", "episode_prepare", "memo_probe",
                 "memo_insert", "episode_step", "allocate_job",
                 "price_and_score", "lookahead"):
        want = steps + (len(fx["collects"]) * 2 if name == "kernel_obs"
                        else 0)
        require(launches[name] == want, f"{name} launched {launches[name]} "
                                         f"times in {steps} steps")
    require(counters["hits"] > 0, "the memo never hit")

    results = {}
    for dtype in (torch.float32, torch.float64):
        diffs, held, _ = device_env_fixture.segment_kernel_diffs(
            et, ot, model, fx["banks"],
            fx["collects"][0]["uniforms"][:, :COLLECT_CHECKED],
            COLLECT_CHECKED, MemoConfig(), device="cuda", dtype=dtype)
        torch.cuda.synchronize()
        for name, value in diffs.items():
            require(value == 0, f"{name} differs from its plain version on "
                                f"the collection's calls ({dtype}): {value}")
            r = results.setdefault(name, _new_result(calls_per_step=1,
                                                     held_calls=0))
            r["held_calls"] += held[name]
    held, reset_calls, reset = _hold_reset(
        et, ot, model, fx["banks"], memo_col,
        [o["trace"] for o in runs[True][0]], fx["reset"])
    for name in SEGMENT_KERNELS:
        results[name]["held_calls"] += held[name]
    results["episode_step"]["reset_calls_held"] = reset_calls

    gen = torch.Generator("cuda").manual_seed(0)
    col = DevicePPOCollector(et, ot, model, fx["banks"], T, device="cuda")
    col.collect(generator=gen)                      # first use, not timed
    torch.cuda.synchronize()
    t0 = time.monotonic()
    timed = col.collect(generator=gen)
    torch.cuda.synchronize()
    collect_s = time.monotonic() - t0
    prof_out, prof = _profile_collect(col, gen)
    bounds = _segment_bounds(et, prof_out["trace"])
    times = _collect_kernel_times(et, ot, model, fx)
    for name in SEGMENT_KERNELS:
        r = results[name]
        r.update(ms=prof["kernel_device_ms_per_launch"][name],
                 eager_ms=times[name]["eager_ms"],
                 plain_ms=times[name]["plain_ms"],
                 bound_ms=bounds[name][0], bound_by=bounds[name][1],
                 shape=(f"collect: lanes=2 steps={T} N={et.pads.n_ops} "
                        f"M={et.pads.n_deps} servers={et.n_srv} "
                        f"channels={et.n_chan} float32, memo 64x2"))
    emit("device_collect", card=card, steps_per_collect=T, lanes=2,
         recorded_collect_s_memo_off=runs[False][1] / len(fx["collects"]),
         recorded_collect_s_memo_on=runs[True][1] / len(fx["collects"]),
         logp_max_abs_err=max(e[0] for e in errs),
         value_max_abs_err=max(e[1] for e in errs),
         last_value_max_abs_err=max(e[2] for e in errs),
         memo=counters, collect_s=collect_s,
         lane_steps_per_s=2 * T / collect_s,
         timing=timed["timing"],
         episodes=len(timed["episodes"]),
         launches={k: v for k, v in launches.items() if v},
         launches_per_step={k: launches[k] / steps for k in
                            SEGMENT_KERNELS})
    emit("device_collect_reset", card=card, **reset)
    emit("device_collect_profile", card=card, **prof,
         bound_ms_per_call={k: v[0] for k, v in bounds.items()},
         bound_bytes_per_call={k: v[2] for k, v in bounds.items()},
         bound_ops_per_call={k: v[3] for k, v in bounds.items()})
    return results


def phase_policy_episode(card):
    """[policy_episode]: ppo_device_trained greedy in-kernel (K4), float64,
    on the bank of the port's host env episode on its surface
    (tests/test_shipped_checkpoint.py's, seed 7009) under the same greedy
    policy: every action, reward, accept and cause equal to the host's, t
    and jct within rel 1e-9, the arrivals and blocks equal."""
    from ddls_tpu_torch.models.policy import prepare_flat_batch

    ck = load_checkpoint_fixture("ppo_device_trained")
    env = RampJobPartitioningEnvironment(**ck["env_config"])
    model = ck["model"].to("cuda").eval()

    def greedy(obs):
        batch = policy_mod.batch_to_device(
            prepare_flat_batch(stack_obs([obs])), "cuda")
        return int(model.flat_batched(batch)[2][0])

    t0 = time.monotonic()
    arrivals, decisions, stats = device_env_fixture.mixed_action_episode(
        env, seed=7009, policy=greedy)
    host_s = time.monotonic() - t0
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    bank = device_env.build_job_bank(et, arrivals)
    fn = device_env.make_policy_episode_fn(et, ot, model, greedy=True,
                                           device="cuda",
                                           dtype=torch.float64)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(bank)
    torch.cuda.synchronize()
    device_s = time.monotonic() - t0
    (action, _, _, reward, accept, cause, jct, t, has_job) = (
        x.cpu().numpy() for x in out["trace"])
    n = len(decisions)
    host = np.array([d[:5] for d in decisions], np.float64)
    hjct = np.array([d[5] for d in decisions])
    require(has_job[:n].all(), "the policy episode ran out of jobs first")
    require(np.array_equal(action[:n], host[:, 0]),
            "the in-kernel greedy actions differ from the host episode's")
    # a job accepted at the last decision is blocked by the simulation's
    # end on the host (its step rewards the block, its record keeps no
    # jct): the episode accepts it, and counts it in blocked_total
    ended = (host[:, 2] > 0) & np.isnan(hjct)
    require(np.array_equal(reward[:n][~ended], host[~ended, 1])
            and np.array_equal(accept[:n], host[:, 2] > 0)
            and np.array_equal(cause[:n], host[:, 3]),
            "the policy episode decides otherwise than the host env")
    ok = (host[:, 2] > 0) & np.isfinite(hjct)
    rel = max(float(np.max(np.abs(t[:n] - host[:, 4])
                           / np.maximum(np.abs(host[:, 4]), 1.0))),
              float(np.max(np.abs(jct[:n][ok] - hjct[ok]) / hjct[ok]))
              if ok.any() else 0.0)
    require(rel <= EPISODE_REL, f"t / jct off the host's by rel {rel}")
    for key in ("arrived", "blocked_total", "completed"):
        require(int(out[key]) == stats[key], f"{key} {int(out[key])} differs "
                                             f"from the host's {stats[key]}")
    emit("policy_episode", card=card, decisions=n, host_episode_s=host_s,
         device_episode_s=device_s, steps=int(has_job.size),
         t_jct_max_rel_err=rel, actions=sorted(set(action[:n].tolist())),
         accepted_at_the_end=int(ended.sum()),
         memo={k: int(out[k]) for k in ("memo_hits", "memo_misses",
                                        "memo_evicts")}, **stats)


# ------------------------------------------- in-kernel candidate pricing
# the kernels each phase's main path adds (K23 with the state-lane index,
# K29, and K30 or K26 with the price block), by their launch-count names
ORACLE_KERNELS = ("allocate_job_indexed", "price_reduce", "oracle_select")
PRICE_POLICY_KERNELS = ("allocate_job_indexed", "price_reduce",
                        "kernel_obs_prices")
# the step of the 8-lane episode whose state the kernels are timed at
PRICED_TIMED_STEP = 200


def _shipped_priced_surface():
    """env_load32_price_mixed as the checkpoint fixture composes it (a
    job every 80, native candidate pricing, the price block in the
    observation), reset from seed 0, and its episode and obs tables."""
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    return env, et, device_env.build_obs_tables(env, et)


def _np_trace(out, names=device_env_fixture.ORACLE_TRACE_NAMES):
    return {name: x.cpu().numpy() for name, x in zip(names, out["trace"])}


def _hold_host(trace, out, decisions, stats, what):
    """A float64 device episode's trace against the port's host episode
    (``mixed_action_episode``'s decisions and stats): every action, accept
    and cause equal, the rewards equal but where the episode's end blocks
    a job accepted at the last decision on the host ([policy_episode]'s
    exception), t and jct within ``EPISODE_REL``, the arrivals, blocks and
    completions equal. Returns (decisions, rel, accepted at the end)."""
    n = len(decisions)
    host = np.array([d[:5] for d in decisions], np.float64)
    hjct = np.array([d[5] for d in decisions])
    require(trace["has_job"][:n].all() and not trace["has_job"][n:].any(),
            f"{what}: the episode decided other steps than the host's")
    require(np.array_equal(trace["action"][:n], host[:, 0]),
            f"{what}: the actions differ from the host episode's")
    ended = (host[:, 2] > 0) & np.isnan(hjct)
    require(np.array_equal(trace["reward"][:n][~ended], host[~ended, 1])
            and np.array_equal(trace["accept"][:n], host[:, 2] > 0)
            and np.array_equal(trace["cause"][:n], host[:, 3]),
            f"{what}: decides otherwise than the host env")
    ok = (host[:, 2] > 0) & np.isfinite(hjct)
    rel = max(float(np.max(np.abs(trace["t"][:n] - host[:, 4])
                           / np.maximum(np.abs(host[:, 4]), 1.0))),
              float(np.max(np.abs(trace["jct"][:n][ok] - hjct[ok])
                           / hjct[ok])) if ok.any() else 0.0)
    require(rel <= EPISODE_REL, f"{what}: t / jct off the host's by rel "
                                f"{rel}")
    for key in ("arrived", "blocked_total", "completed"):
        require(int(out[key]) == stats[key], f"{what}: {key} "
                                             f"{int(out[key])} differs from "
                                             f"the host's {stats[key]}")
    return n, rel, int(ended.sum())


def _k29_work(args):
    """The least bytes and operations of one K29 call, from the call's own
    arguments (``price_reduce``'s): every lane's queue row and done flag
    and every row's two outputs; a row of a lane with a job its three
    verdicts and its time, the lane its steps; and only a row whose
    verdicts pass (the kernel skips the others: ok is a conjunction) its
    configuration and valid-prefix entry, its prefix's flow flags, a
    channel a flow, and the lane's occupancy of each distinct channel its
    passing rows' flows name; one operation a scanned dep."""
    (is_flow, chan, ok_place, finite_ok, t_step, ok_la, state, bank, cfg,
     n_deps) = args
    fb = t_step.element_size()
    rows, m = is_flow.shape
    lanes = state["queue_row"].shape[0]
    n_deg, n_chan = rows // lanes, state["chan_occ"].shape[1]
    has_job = (state["queue_row"] >= 0) & ~state["done"]
    active = has_job.repeat_interleave(n_deg)
    scan = active & ok_place & ok_la & finite_ok
    nd = n_deps[cfg.long()].clamp(0, m)
    flows = is_flow & scan[:, None] & (
        torch.arange(m, device=is_flow.device)[None] < nd[:, None])
    lane = torch.arange(rows, device=is_flow.device) // n_deg
    channels = torch.unique((lane[:, None] * n_chan + chan.long())[flows])
    n_scan = int(scan.sum())
    scanned = int(nd[scan].sum())
    nbytes = (lanes * (4 + 1) + rows * (1 + fb) + int(has_job.sum()) * fb
              + int(active.sum()) * (3 + fb) + n_scan * (4 + 4) + scanned
              + 4 * int(flows.sum()) + 4 * int(channels.numel()))
    return nbytes, scanned


def _priced_bounds(et, types, has_job, dtype, policy_rows=0, k29=None):
    """Per call, the least bytes and operations of K23 (indexed), K30, K26
    (prices) and, given ``k29`` (the bytes and operations summed over the
    episode's calls, ``_k29_work``), K29 over an episode's steps:
    ``types`` [D, B] the queued job's type and ``has_job`` [D, B] whether
    a lane priced at each step (the rows of lanes without a job are not
    read). K23 counts as ``_k23_work``'s indexed calls over the n_deg rows
    of each pricing lane; K30 a deciding lane's verdicts and prices, its
    server occupancy, its bank row and type's sum, the degrees and their
    shapes and the action, an operation a server and three a degree; K26
    (``policy_rows`` graph features a row) a row's fields, static row, the
    row, mask and price block written, the verdicts and prices."""
    tb = et.tables
    fb = 4 if dtype == torch.float32 else 8
    n_deg, S = len(et.degrees), et.n_srv
    A = et.max_action + 1
    D, B = types.shape
    cfg = (types[:, :, None] * n_deg + np.arange(n_deg)).reshape(D, -1)
    active = np.repeat(has_job, n_deg, axis=1).astype(np.float64)
    k23 = _k23_work(et, cfg, active, fb, n_deg)
    lanes = has_job.astype(np.float64)
    k30 = (float(np.sum(lanes * (n_deg * (1 + fb + 4 + 1) + S * 4 + 4 + 1
                                 + 4 + 3 * fb + 4))),
           float(np.sum(lanes * (S + 3 * n_deg))))
    k26 = (float(np.sum(lanes * (16 + 2 * fb + policy_rows * 4
                                 + (policy_rows + A) * 4 + A * 4
                                 + n_deg * (1 + fb)))),
           float(np.sum(lanes * (policy_rows + 3 * A))))
    work = [("allocate_job_indexed", k23), ("oracle_select", k30),
            ("kernel_obs_prices", k26)]
    if k29 is not None:
        work.append(("price_reduce", k29))
    out = {}
    for name, (nbytes, ops) in work:
        b, by = bound_ms(nbytes, ops)
        out[name] = (b / D, by, nbytes / D, ops / D)
    return out


def phase_oracle(card):
    """[oracle]: the in-kernel OracleJCT episode
    (``make_oracle_episode_fn``) at full width on env_load32_price_mixed
    (45 configs, 9 degrees: 72 pricing rows at 8 lanes), float32, the
    memo on: (a) bench.py's banks 0-7 (420 jobs every 50) at 1 lane each
    and at 8 lanes, the 8-lane run counted (K23 indexed, K29 and K30 once
    a step); each of the 8 lanes equal to its bank alone; banks 0 and 1's
    first steps equal to the recorded JAX float32 episode (actions,
    accept, cause, reward, t and jct bit-equal); (b) every call of K23
    (indexed), K29 and K30 of the 8-lane episode against its plain
    version, bit for bit, its trace the counted run's and its first steps'
    pricing the recorded JAX ``price_all``'s, and the new kernels and
    their plain versions timed on the calls of step 200 (its wall
    includes that timing); (c) the float64 episode of the port's host
    env's OracleJCT episode (native pricing, a job every 80, seed 7005),
    decision for decision; (d) decisions/s at 1 and 8 lanes, device ms a
    step by kernel and launches a step under torch.profiler."""
    from ddls_tpu_torch.sim.device_memo import MemoConfig

    ofx = device_env_fixture.load_oracle_fixture()
    dfx = device_env_fixture.load_device_env_fixture()
    env, et, ot = _shipped_priced_surface()
    require(et.types == ofx["full"]["types"] == dfx["types"],
            "the shipped surface's model types differ from the recordings'")
    banks = dfx["banks"]
    J = banks["type"].shape[1]
    lanes8 = list(range(8))
    fn = device_env.make_oracle_episode_fn(et, ot, device="cuda",
                                           dtype=torch.float32)

    def run(lanes):
        bank = {k: v[lanes] for k, v in banks.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn(bank)
        torch.cuda.synchronize()
        return out, time.monotonic() - t0

    run([0])                                 # first use, not timed
    one = [run([lane]) for lane in lanes8]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out8, wall8 = run(lanes8)
    launches = kernels.launch_counts()
    for name in ORACLE_KERNELS + ("allocate_job", "episode_prepare",
                                  "episode_step"):
        require(launches[name] == J, f"{name} launched {launches[name]} "
                                     f"times in the {J} steps of the "
                                     "8-lane oracle episode")
    for name in ("price_and_score", "lookahead"):
        require(launches[name] == 2 * J, f"{name} launched "
                                         f"{launches[name]} times in {J} "
                                         "steps (pricing and decision)")
    for lane, (alone, _) in enumerate(one):
        for s, a in zip(out8["trace"], alone["trace"]):
            require(torch.equal(s[lane], a[0]),
                    f"lane {lane} of 8 differs from its bank alone")
        for key in ("accepted", "blocked", "ret", "completed", "t", "done",
                    "blocked_total", "arrived"):
            require(torch.equal(out8[key][lane], alone[key][0]),
                    f"lane {lane} of 8: {key} differs from its bank alone")
    trace8 = _np_trace(out8)
    rec = ofx["full"]["oracle"]
    P = ofx["full"]["prefix"]
    seeds = [int(s) for s in ofx["full"]["seeds"]]
    for i, seed in enumerate(seeds):
        for name in device_env_fixture.ORACLE_TRACE_NAMES:
            require(np.array_equal(trace8[name][seed, :P],
                                   rec["trace"][name][i]),
                    f"bank {seed}: {name} differs from the recorded JAX "
                    "float32 oracle episode")

    # (b) every call held against its plain version, and the new kernels
    # timed on the calls of step PRICED_TIMED_STEP
    timed = {}
    k29 = [0, 0]

    def time_call(d, name, kernel, plain):
        if name == "price_reduce":
            k29[:] = np.add(k29, _k29_work(kernel.args))
        if d == PRICED_TIMED_STEP:
            timed[name] = (eager_ms(kernel), eager_ms(plain, iters=3))

    bank8 = _episode_bank(banks, lanes8, torch.float32)
    t0 = time.monotonic()
    diffs, held, stepped = device_env_fixture.priced_episode_diffs(
        et, ot, bank8, J, memo_cfg=MemoConfig(), device="cuda",
        dtype=torch.float32, at_call=time_call)
    torch.cuda.synchronize()
    held_s = time.monotonic() - t0
    for name, value in diffs.items():
        require(value == 0, f"{name} differs from its plain version on the "
                            f"oracle episode's calls: {value}")
    for name in device_env_fixture.ORACLE_TRACE_NAMES:
        require(np.array_equal(stepped[name].cpu().numpy(), trace8[name]),
                f"the held episode's {name} differs from the counted run's")
    for name in ("price_ok", "price_jct"):
        got = stepped[name].cpu().numpy()[seeds, :P]
        require(np.array_equal(got, rec[name]), f"price_all's {name} "
                "differs from the recorded JAX float32 one")

    # (c) float64 against the port's host OracleJCT
    host_env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    t0 = time.monotonic()
    arrivals, decisions, stats = device_env_fixture.oracle_episode(
        host_env, 7005)
    host_s = time.monotonic() - t0
    et64 = device_env.build_episode_tables(host_env)
    ot64 = device_env.build_obs_tables(host_env, et64)
    fn64 = device_env.make_oracle_episode_fn(et64, ot64, device="cuda",
                                             dtype=torch.float64)
    bank64 = device_env.build_job_bank(et64, arrivals)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out64 = fn64(bank64)
    torch.cuda.synchronize()
    device64_s = time.monotonic() - t0
    n64, rel64, ended64 = _hold_host(_np_trace(out64), out64, decisions,
                                     stats, "the float64 oracle episode")

    # (d) the profile
    n_dec = int(trace8["has_job"].sum())
    by_launch, prof = _profile_by_kernel(lambda: fn(
        {k: v[lanes8] for k, v in banks.items()}), J)
    alloc = next(v for k, v in by_launch.items()
                 if "allocate_job_kernel<" in k)
    # each step launches K23 for the pricing rows first, then for the
    # decision: the indexed launches are the even ones
    ms = {"allocate_job_indexed": float(np.mean(alloc[0::2]))}
    for name in ("price_reduce", "oracle_select"):
        times = next(v for k, v in by_launch.items()
                     if f"{name}_kernel<" in k)
        ms[name] = float(np.mean(times))
    types = np.where(trace8["has_job"], banks["type"][:, :J], 0).T
    bounds = _priced_bounds(et, types, trace8["has_job"].T, torch.float32,
                            k29=tuple(float(x) for x in k29))
    results = {}
    for name in ORACLE_KERNELS:
        results[name] = _new_result(
            calls_per_step=1, held_calls=held[name], ms=ms[name],
            eager_ms=timed[name][0], plain_ms=timed[name][1],
            bound_ms=bounds[name][0], bound_by=bounds[name][1],
            max_abs_err=diffs[name],
            shape=(f"oracle episode: lanes=8 steps={J} "
                   f"rows={8 * len(et.degrees)} N={et.pads.n_ops} "
                   f"M={et.pads.n_deps} float32, timed at step "
                   f"{PRICED_TIMED_STEP}"))
    emit("oracle", card=card, steps=J, decisions_8_lanes=n_dec,
         decisions_per_s_1_lane=float(np.mean(
             [int(o["trace"][6].sum()) / w for o, w in one])),
         decisions_per_s_8_lanes=n_dec / wall8,
         episode_s_1_lane=float(np.mean([w for _, w in one])),
         episode_s_8_lanes=wall8, held_episode_s=held_s,
         held_calls={k: v for k, v in held.items() if v},
         recorded_prefix=P, recorded_banks=seeds,
         accepted=out8["accepted"].tolist(),
         actions=sorted(set(trace8["action"][trace8["has_job"]].tolist())),
         memo={k: out8[k].tolist() for k in ("memo_hits", "memo_misses")},
         host_f64={"decisions": n64, "t_jct_max_rel_err": rel64,
                   "accepted_at_the_end": ended64, "host_episode_s": host_s,
                   "device_episode_s": device64_s, **stats},
         launches={k: v for k, v in launches.items() if v},
         launches_per_step={k: v / J for k, v in launches.items() if v},
         profile=prof,
         bound_ms_per_call={k: bounds[k][0] for k in ORACLE_KERNELS},
         bound_bytes_per_call={k: bounds[k][2] for k in ORACLE_KERNELS})
    return results, launches


def phase_price_policy_episode(card):
    """[price_policy_episode]: ppo_price_mixed greedy in-kernel with the
    price block (``make_policy_episode_fn`` over price-feature tables:
    ``price_all`` then K26 with prices each step), float64, on the bank
    of the port's host env episode under the same greedy policy on
    [eval]'s surface and seed (a job every 80, native candidate pricing,
    seed 7005), counted: every action, accept and cause equal, rewards but
    [policy_episode]'s exception, returns within 1e-9; then the first
    steps of bench.py's bank 0 at full width in float32, every call of
    K23 (indexed), K29 and K26 (prices) held against its plain version,
    against the recorded JAX float32 episode: the trace equal and the
    price block bit-equal."""
    from ddls_tpu_torch.models.policy import prepare_flat_batch

    ck = load_checkpoint_fixture("ppo_price_mixed")
    env = RampJobPartitioningEnvironment(**ck["env_config"])
    model = ck["model"].to("cuda").eval()

    def greedy(obs):
        batch = policy_mod.batch_to_device(
            prepare_flat_batch(stack_obs([obs])), "cuda")
        return int(model.flat_batched(batch)[2][0])

    t0 = time.monotonic()
    arrivals, decisions, stats = device_env_fixture.mixed_action_episode(
        env, seed=7005, policy=greedy)
    host_s = time.monotonic() - t0
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    require(bool(ot["with_prices"]), "the shipped surface's observation "
                                     "carries no price block")
    bank = device_env.build_job_bank(et, arrivals)
    fn = device_env.make_policy_episode_fn(et, ot, model, greedy=True,
                                           device="cuda",
                                           dtype=torch.float64)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = fn(bank)
    torch.cuda.synchronize()
    device_s = time.monotonic() - t0
    launches = kernels.launch_counts()
    J = len(bank["type"])
    for name in PRICE_POLICY_KERNELS + ("mask_logits_argmax",):
        require(launches[name] == J, f"{name} launched {launches[name]} "
                                     f"times in the policy episode's {J} "
                                     "steps")
    trace = _np_trace(out, ("action", "logp", "value")
                      + device_env_fixture.ORACLE_TRACE_NAMES[1:])
    n, rel, ended = _hold_host(trace, out, decisions, stats,
                               "the price-feature policy episode")
    ret_err = abs(float(out["ret"]) - float(np.sum([d[1] for d in
                                                    decisions])))
    require(ret_err <= 1e-9 + 2.0 * ended, f"the episode's return is off "
                                           f"the host's by {ret_err}")
    by_launch, prof = _profile_by_kernel(lambda: fn(bank), J)
    k26_ms = float(np.mean(next(v for k, v in by_launch.items()
                                if "kernel_obs_kernel<" in k)))

    # the recorded JAX float32 prefix, every call held
    ofx = device_env_fixture.load_oracle_fixture()["full"]
    rec, P = ofx["policy"], ofx["prefix"]
    banks = device_env_fixture.load_device_env_fixture()["banks"]
    seed = int(ofx["seeds"][0])
    bank32 = _episode_bank(banks, [seed], torch.float32)
    diffs, held, stepped = device_env_fixture.priced_episode_diffs(
        et, ot, bank32, P, model, device="cuda", dtype=torch.float32)
    for name, value in diffs.items():
        require(value == 0, f"{name} differs from its plain version on the "
                            f"price-feature episode's calls: {value}")
    for name in device_env_fixture.ORACLE_TRACE_NAMES:
        require(np.array_equal(stepped[name][0].cpu().numpy(),
                               rec["trace"][name]),
                f"{name} differs from the recorded JAX float32 price-"
                "feature policy episode")
    require(np.array_equal(stepped["price_block"][0].cpu().numpy(),
                           rec["price_block"]),
            "K26's price block differs from the recorded JAX float32 one")
    dobs = device_env.device_obs(ot, device_env.device_tables(
        et, "cuda", torch.float64))
    f = [torch.from_numpy(np.ascontiguousarray(rec[name])).to(
        "cuda", want or torch.float64)
        for name, want in device_env.OBS_FIELDS]
    prices = (torch.from_numpy(rec["price_ok"]).cuda(),
              torch.from_numpy(rec["price_jct"]).to("cuda", torch.float64))
    bounds = _priced_bounds(et, np.where(trace["has_job"], bank["type"],
                                         0)[:, None],
                            trace["has_job"][:, None], torch.float64,
                            policy_rows=ot["graph_features"].shape[1])
    name = "kernel_obs_prices"
    result = _new_result(
        calls_per_step=1, held_calls=held["kernel_obs_prices"],
        ms=k26_ms, max_abs_err=diffs["kernel_obs_prices"],
        eager_ms=eager_ms(lambda: device_env.kernel_obs(dobs, *f,
                                                        prices=prices)),
        plain_ms=eager_ms(lambda: device_env.kernel_obs_plain(
            dobs, *f, prices=prices), iters=3),
        bound_ms=bounds[name][0], bound_by=bounds[name][1],
        shape=(f"price-feature policy episode: 1 lane, {J} steps, float64; "
               f"timed on the {P} recorded rows"))
    emit("price_policy_episode", card=card, decisions=n, steps=J,
         host_episode_s=host_s, device_episode_s=device_s,
         decisions_per_s=n / device_s, t_jct_max_rel_err=rel,
         return_err=ret_err, accepted_at_the_end=ended,
         actions=sorted(set(trace["action"][:n].tolist())),
         recorded_prefix=P, held_calls={k: v for k, v in held.items()
                                        if v},
         launches={k: v for k, v in launches.items() if v},
         profile=prof, bound_ms_per_call=bounds[name][0], **stats)
    return {name: result}, launches


def phase_device_train(card):
    """[device_train], the slice's main path: ``python -m
    ddls_tpu_torch.train --config train_config_ppo_device_load32.json
    --epochs 2`` in this process, as the config asks (pipelined, 2 lanes x
    128 steps collected on the card, the memo on, an evaluation of 3
    greedy host episodes each epoch), the launch counters reset just
    before and read just after; run twice from one seed, bit-equal."""
    runs, launches = [], None
    for attempt in range(2):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        lines = _run_train_cli(["--config", DEVICE_CONFIG_PATH, "--epochs",
                                "2", "--device", "cuda"])
        wall = time.monotonic() - t0
        if attempt == 0:
            launches = kernels.launch_counts()
        runs.append((lines, wall))
    (lines0, wall0), (lines1, _) = runs
    require([_deterministic(x) for x in lines0]
            == [_deterministic(x) for x in lines1],
            "two runs of the device-collection loop printed different "
            "results")
    epochs = lines0[:-1]
    for line in epochs:
        require(line["env_steps_this_iter"] == 256,
                f"an epoch collected {line['env_steps_this_iter']} steps")
        require(line["loop_mode"] == "pipelined", "not the config's mode")
        require(all(np.isfinite(v) for v in line["learner"].values()),
                "non-finite learner metrics")
    for name in (*SEGMENT_KERNELS, "allocate_job", "price_and_score",
                 "lookahead", "minibatch_gather", "mask_sample_logp",
                 "gae_normalize", "ppo_loss", "clip_adam"):
        require(launches[name] > 0, f"kernel {name} was not launched by the "
                                    "device-collection loop")
    split = [{"collect_s": x["timing"]["collect_s"],
              "update_s": x["timing"]["update_s"],
              "evaluation_s": x["epoch_time"] - x["timing"]["collect_s"]
              - x["timing"]["update_s"]} for x in epochs]
    emit("device_train", card=card, wall_s=wall0, epochs=len(epochs),
         split=split, learner=[x["learner"] for x in epochs],
         episode_reward_mean=[x.get("episode_reward_mean") for x in epochs],
         evaluation=[x.get("evaluation") for x in epochs],
         launches={k: v for k, v in launches.items() if v})
    return launches


# ---------------------------------------- scenarios and the failure walk
SCENARIO_PATH = device_env_fixture.FULL_SCENARIO_PATH
# the registry specs whose conformance legs run on the card; multi_channel
# runs only its jitted leg, which is skipped off the dense topology
CONFORMANCE_SPECS = ("failures", "canonical")
CONFORMANCE_LEGS = ("host_native", "host_jax", "host_jitted", "golden")
# the lanes of the full-width scenario replay: the two recorded banks and
# sample_job_bank's seeds 2-7
SCENARIO_LANES = 8
SCENARIO_BANK_JOBS = 420
# the failure walk's branches each run must take
WALK_TAKEN = ("preempt_push", "straggle_fit", "straggle_spill")


def phase_scenario(card):
    """[scenario], on the host: (a) every recorded spec's fingerprint,
    failure windows and loadgen trace fingerprint and gaps equal to the
    recording's; (b) the port's conformance harness on the card
    (``scenarios/conformance.py``, ``device="cuda"``) on failures and
    canonical: host_native, host_jax (K21), host_jitted (the device
    episode in float64) and golden all ok; multi_channel's host_jitted
    skipped with the reason."""
    from ddls_tpu_torch import scenarios
    from ddls_tpu_torch.demands.distributions import LoadgenInterarrival
    from ddls_tpu_torch.scenarios import conformance

    fx = device_env_fixture.load_scenario_fixture()
    specs = {}
    for name, rec in fx["specs"].items():
        spec = scenarios.get_spec(SCENARIO_PATH if name == "failures_load32"
                                  else name)
        require(scenarios.spec_fingerprint(spec) == rec["fingerprint"],
                f"spec {name}: fingerprint differs from the recording")
        windows = scenarios.resolve_failure_windows(
            spec, int(rec["n_servers"]), int(rec["n_channels"]))
        for key in ("kind", "resource", "t0", "t1", "rate"):
            require(np.array_equal(np.array([w[key] for w in windows]
                                            ).reshape(-1),
                                   rec["windows"][key]),
                    f"spec {name}: window {key} differs from the recording")
        entry = {"fingerprint": rec["fingerprint"], "windows": len(windows)}
        if rec["loadgen"] is not None:
            knobs = {k: v for k, v in spec.arrival.items() if k != "kind"}
            dist = LoadgenInterarrival(**knobs)
            require(dist.trace_fingerprint == rec["loadgen"]["fingerprint"]
                    and np.array_equal(dist._gaps, rec["loadgen"]["gaps"]),
                    f"spec {name}: the loadgen trace differs")
            entry["loadgen_fingerprint"] = dist.trace_fingerprint
        specs[name] = entry
    legs = {}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    for name in CONFORMANCE_SPECS:
        report = conformance.run_conformance(
            scenarios.get_spec(name), seed=0, legs=CONFORMANCE_LEGS,
            device="cuda")
        for leg in report["legs"]:
            require(leg["status"] == "ok", f"conformance {name}: {leg}")
        legs[name] = {leg["leg"]: {k: leg.get(k) for k in
                                   ("status", "decisions", "rtol")}
                      for leg in report["legs"]}
    report = conformance.run_conformance(
        scenarios.get_spec("multi_channel"), seed=0,
        legs=("host_jitted",), device="cuda")
    leg = report["legs"][0]
    require(leg["status"] == "skipped" and "single-channel" in
            leg["reason"], f"multi_channel's jitted leg: {leg}")
    legs["multi_channel"] = {"host_jitted": leg}
    seconds = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name in ("lookahead", "episode_step", "episode_step_scenario"):
        require(launches[name] > 0, f"the conformance legs did not launch "
                                    f"{name}")
    emit("scenario", card=card, specs=specs, conformance=legs,
         conformance_s=seconds,
         launches={k: v for k, v in launches.items() if v})


def _scenario_bounds(et, prof, dtype):
    """K25's bound with the failure walk: nominal K25's bytes and
    operations (``_episode_bounds``) plus, a call, the speeds and the
    windows' t0, t1, rate, kind and resource read once, and a deciding
    lane's walk (the server mask's minimum, ten operations a window)."""
    fb = 4 if dtype == torch.float32 else 8
    W = len(et.scenario["kind"])
    D = prof["decisions"]
    base = _episode_bounds(et, prof, dtype)["episode_step"]
    nbytes = base[2] + (et.n_srv + 3 * W) * fb + 2 * W * 4
    ops = base[3] + float(np.sum(prof["active"])) / D * (et.n_srv + 10 * W)
    b, by = bound_ms(nbytes, ops)
    return b, by, nbytes, ops


def phase_scenario_episode(card):
    """[scenario_episode]: the full-width failure spec
    (``ddls_tpu_torch/data/scenario_failures_load32.json``: 32 servers, 32
    windows) replayed on the card from the recording
    (``scenario_recorded.npz``), K25 in scenario mode: (a) float32: the 2
    recorded JAX banks at 1 lane and, with 6 more banks, at 8 lanes (the
    counted main path) held bit for bit, each other lane equal to its
    bank alone; float64: bank 0 against the recorded x64 replay and the
    port's host env's own episode (native engine) decision for decision;
    (b) every K25 call of the 8-lane float32 and 1-lane float64 replays
    bit-equal to its plain version, and the walk's branches counted; (c)
    C1's bank (three ticks of four completions, canonical spec) bit-equal
    to its recorded JAX replay, each kernel call against its plain
    version; (d) decisions/s at 1 and 8 lanes, and K25's device ms a
    launch under torch.profiler with the walk and without it (the same
    banks and actions on the spec's tables without the scenario)."""
    import dataclasses

    from ddls_tpu_torch import scenarios
    from ddls_tpu_torch.scenarios import conformance

    fxm = device_env_fixture
    fx = fxm.load_scenario_fixture()
    full = fx["full"]
    env = conformance.build_env(scenarios.get_spec(SCENARIO_PATH), "host",
                                device="cuda")
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    require(et.types == full["types"] and et.scenario is not None,
            "the full-width spec's tables differ from the recording's")
    # the recorded banks, then sample_job_bank's seeds 2-7
    extra = [device_env.sample_job_bank(et, env, SCENARIO_BANK_JOBS, s)
             for s in range(2, SCENARIO_LANES)]
    banks = {k: np.concatenate([v, np.stack([b[k] for b in extra])])
             for k, v in full["banks"].items()}
    actions = full["actions"]
    D = len(actions)
    lanes = list(range(SCENARIO_LANES))
    info, launches = {}, None
    for dtype, key in ((torch.float32, "f32"), (torch.float64, "x64")):
        fn = device_env.make_episode_fn(et, device="cuda", dtype=dtype)
        recorded = list(range(full[key]["trace"]["cause"].shape[0]))
        _replay(fn, banks, actions[:4], [0])        # first use, not timed
        worst, one_lane_s, alone = 0.0, [], {}
        for lane in recorded:
            out, wall = _replay(fn, banks, actions, [lane])
            one_lane_s.append(wall)
            alone[lane] = out
            worst = max(worst, _hold_replay(out, [0], full[key], [lane],
                                            dtype, f"scenario {key} bank "
                                                   f"{lane}, 1 lane"))
        if dtype == torch.float32:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out8, wall8 = _replay(fn, banks, actions, lanes)
            launches = kernels.launch_counts()
            for name in ("allocate_job", "price_and_score", "lookahead",
                         "episode_step_scenario"):
                require(launches[name] == D, f"{name} launched "
                                             f"{launches[name]} times in {D} "
                                             f"decisions")
            require(launches["episode_step"] == 0, "the scenario replay "
                                                   "launched nominal K25")
            worst = max(worst, _hold_replay(out8, recorded, full[key],
                                            recorded, dtype,
                                            "scenario f32, 8 lanes"))
            for lane in lanes:
                one = alone.get(lane)
                if one is None:
                    one, _ = _replay(fn, banks, actions, [lane])
                for s, a in zip(out8["trace"], one["trace"]):
                    require(_diff(s[lane], a[0]) == 0,
                            f"scenario lane {lane} of 8 differs from its "
                            f"bank replayed alone")
            n_dec = int(out8["trace"][5].sum())
            info[key] = {"decisions_per_s_1_lane": D / float(np.mean(
                one_lane_s)), "decisions_per_s_8_lanes": D * 8 / wall8,
                "job_decisions_8_lanes": n_dec,
                "job_decisions_per_s_8_lanes": n_dec / wall8}
        else:
            info[key] = {"decisions_per_s_1_lane": D / float(np.mean(
                one_lane_s))}
        info[key].update(t_jct_max_rel_err=worst,
                         episode_s_1_lane=float(np.mean(one_lane_s)))

    # (b) every K25 call against its plain version, the walk's branches
    results = {"episode_step_scenario": _new_result(held_calls=0)}
    r = results["episode_step_scenario"]
    branches = {}
    for dtype, rows in ((torch.float32, lanes), (torch.float64, [0])):
        ek = device_env.episode_kernels(et, device="cuda", dtype=dtype)
        bank = _episode_bank(banks, rows, dtype)
        acts = torch.from_numpy(np.stack([actions] * len(rows))).to(
            "cuda", torch.int32)
        diff, held, _, br = fxm.scenario_episode_diffs(ek, bank, acts, D)
        torch.cuda.synchronize()
        require(diff == 0, f"K25's scenario mode differs from its plain "
                           f"version ({dtype}): {diff}")
        r["held_calls"] += held
        branches[str(dtype).split(".")[-1]] = br
    for name in WALK_TAKEN:
        require(branches["float32"][name] > 0, f"the 8-lane replay never "
                                               f"took the walk's {name}")

    # the port's host env's own episode on the spec, in float64
    host_env = conformance.build_env(scenarios.get_spec(SCENARIO_PATH),
                                     "native", device="cuda")
    t0 = time.monotonic()
    arrivals, decisions, stats = fxm.mixed_action_episode(host_env)
    host_s = time.monotonic() - t0
    _, host_rel, causes = _hold_host_episode(host_env, arrivals, decisions,
                                             stats)

    # (c) C1's bank: three ticks complete four slots each
    c1 = fx["c1"]
    c1_env = conformance.build_env(scenarios.canonical_spec(), "host",
                                   device="cuda")
    c1_env.reset(seed=0)
    c1_et = device_env.build_episode_tables(c1_env)
    require(c1_et.types == c1["types"], "C1's surface differs")
    c1_bank = {k: v[None] for k, v in c1["bank"].items()}
    c1_fn = device_env.make_episode_fn(c1_et, device="cuda",
                                       dtype=torch.float32)
    c1_out, _ = _replay(c1_fn, c1_bank, c1["actions"], [0])
    _hold_replay(c1_out, [0], c1["f32"], [0], torch.float32, "C1's bank")
    c1_ek = device_env.episode_kernels(c1_et, device="cuda",
                                       dtype=torch.float32)
    c1_err, c1_held, _ = fxm.episode_kernel_diffs(
        c1_ek, _episode_bank(c1_bank, [0], torch.float32),
        torch.from_numpy(c1["actions"][None]).to("cuda", torch.int32),
        len(c1["actions"]), (0,))
    torch.cuda.synchronize()
    require(all(v == 0 for v in c1_err.values()), f"C1's kernel calls "
                                                  f"differ: {c1_err}")

    # (d) K25's device time with the walk and without it, each from a
    # profile that caught every launch (one that missed launches is taken
    # again, up to three times; the line says how it went)
    fx8 = {"banks": banks, "actions": actions}

    def whole_profile(table):
        for attempt in range(1, 4):
            prof = _profile_episode(table, fx8, torch.float32, lanes)
            caught = prof["kernel_launches_per_step"]
            complete = all(caught.get(k) == 1.0 for k in EPISODE_KERNELS)
            if complete:
                break
        return prof, {"attempts": attempt, "complete": complete,
                      "launches_per_decision": caught}

    prof, caught = whole_profile(et)
    nominal_et = dataclasses.replace(et, scenario=None, on_device={})
    prof_nom, caught_nom = whole_profile(nominal_et)
    nominal_fn = device_env.make_episode_fn(nominal_et, device="cuda",
                                            dtype=torch.float32)
    _replay(nominal_fn, banks, actions[:4], [0])
    _, nominal_1 = _replay(nominal_fn, banks, actions, [0])
    _, nominal_8 = _replay(nominal_fn, banks, actions, lanes)
    bound, bound_by, nbytes, ops = _scenario_bounds(et, prof,
                                                    torch.float32)
    ek = device_env.episode_kernels(et, device="cuda", dtype=torch.float32)
    bank = _episode_bank(banks, lanes, torch.float32)
    acts = torch.from_numpy(np.stack([actions] * len(lanes))).to(
        "cuda", torch.int32)
    state = ek.init_state(bank, acts)
    raw = ek.evaluate(state)
    trace = {name: torch.zeros(acts.shape, dtype=want or torch.float32,
                               device="cuda")
             for name, want in device_env.TRACE_FIELDS}

    def step_plain():
        s2 = {k: v.clone() for k, v in state.items()}
        device_env.episode_step_plain(ek, s2, bank, acts, raw, trace, 0)

    clones = [{k: v.clone() for k, v in state.items()} for _ in range(20)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for s in clones:
        device_env.episode_step(ek, s, bank, acts, raw, trace, 0)
    end.record()
    end.synchronize()
    per = prof["kernel_device_ms_per_launch"]
    r.update(ms=per["episode_step"],
             eager_ms=start.elapsed_time(end) / len(clones),
             plain_ms=eager_ms(step_plain, iters=3), bound_ms=bound,
             bound_by=bound_by,
             shape=(f"scenario episode: lanes={SCENARIO_LANES} "
                    f"decisions={D} servers={et.n_srv} "
                    f"channels={et.n_chan} windows="
                    f"{len(et.scenario['kind'])} float32"))
    emit("scenario_episode", card=card, decisions=D, lanes=SCENARIO_LANES,
         windows=len(et.scenario["kind"]), **info,
         nominal_decisions_per_s_1_lane=D / nominal_1,
         nominal_decisions_per_s_8_lanes=D * SCENARIO_LANES / nominal_8,
         walk_branches=branches, k25_calls_held=r["held_calls"],
         k25_scenario_device_ms_per_launch=per["episode_step"],
         k25_nominal_device_ms_per_launch=prof_nom[
             "kernel_device_ms_per_launch"]["episode_step"],
         device_ms_per_decision=prof["kernel_device_ms_per_step"],
         nominal_device_ms_per_decision=prof_nom[
             "kernel_device_ms_per_step"],
         device_busy_share=prof["device_busy_share"],
         profiles={"scenario": caught, "nominal": caught_nom},
         bound_bytes_per_call=nbytes, bound_ops_per_call=ops,
         host_env={"decisions": len(decisions), "host_episode_s": host_s,
                   "t_jct_max_rel_err": host_rel, "causes": causes,
                   **stats},
         c1={"held_calls": c1_held, "completed": int(
             c1_out["completed"][0])},
         launches={k: v for k, v in launches.items() if v})
    return results, launches


def phase_scenario_device_train(card):
    """[scenario_device_train]: ``python -m ddls_tpu_torch.train`` on
    ``train_config_ppo_device_load32.json`` with ``epoch_loop.scenario``
    the full-width spec's absolute path (the config's env_config replaces
    the spec's keys; the runtime rides into the device collector's tables
    and the evaluation envs), 2 epochs, twice from one seed and bit-equal:
    the first run with every K25 call held against its plain version on
    clones of its inputs, the second counted; its collect, update and
    evaluation split."""
    import tempfile

    with open(DEVICE_CONFIG_PATH) as fh:
        cfg = json.load(fh)
    cfg["epoch_loop"]["scenario"] = os.path.abspath(SCENARIO_PATH)
    held = {"calls": 0, "max_abs_err": 0.0}
    kernel_step = device_env.episode_step

    def holding_step(ek, state, bank, actions, raw, trace, d, **kw):
        if ek.dev.scenario is None:
            return kernel_step(ek, state, bank, actions, raw, trace, d,
                               **kw)
        # one clone per tensor: the segment's counters are views of its
        # trace's entries, and the plain version must write them alike
        clones = {}
        copies = [{k: clones.setdefault(id(v), v.clone())
                   for k, v in x.items()} if x is not None else None
                  for x in (state, trace, kw.get("seg_trace"),
                            kw.get("fields"))]
        kernel_step(ek, state, bank, actions, raw, trace, d, **kw)
        device_env.episode_step_plain(
            ek, copies[0], bank, actions, raw, copies[1], d,
            seg_trace=copies[2], fields=copies[3],
            reset=kw.get("reset", False))
        for got, want in zip((state, trace, kw.get("seg_trace"),
                              kw.get("fields")), copies):
            for k in (got or {}):
                held["max_abs_err"] = max(held["max_abs_err"],
                                          _diff(got[k], want[k]))
        held["calls"] += 1

    runs, launches = [], None
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_config_scenario.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        for attempt in range(2):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if attempt == 0:
                device_env.episode_step = holding_step
            try:
                t0 = time.monotonic()
                lines = _run_train_cli(["--config", path, "--epochs", "2",
                                        "--device", "cuda"])
                wall = time.monotonic() - t0
            finally:
                device_env.episode_step = kernel_step
            if attempt == 1:
                launches = kernels.launch_counts()
            runs.append((lines, wall))
    (lines0, _), (lines1, wall1) = runs
    require([_deterministic(x) for x in lines0]
            == [_deterministic(x) for x in lines1],
            "two runs of the scenario device-collection loop printed "
            "different results")
    require(held["calls"] == 256 and held["max_abs_err"] == 0,
            f"K25's scenario mode against its plain version in the loop: "
            f"{held}")
    epochs = lines1[:-1]
    for line in epochs:
        require(line["env_steps_this_iter"] == 256,
                f"an epoch collected {line['env_steps_this_iter']} steps")
        require(all(np.isfinite(v) for v in line["learner"].values()),
                "non-finite learner metrics")
    require(launches["episode_step_scenario"] == 256 and
            launches["episode_step"] == 0,
            f"the loop launched K25 {launches['episode_step_scenario']} "
            f"times in scenario mode, {launches['episode_step']} nominal")
    split = [{"collect_s": x["timing"]["collect_s"],
              "update_s": x["timing"]["update_s"],
              "evaluation_s": x["epoch_time"] - x["timing"]["collect_s"]
              - x["timing"]["update_s"]} for x in epochs]
    emit("scenario_device_train", card=card, wall_s=wall1,
         epochs=len(epochs), split=split, k25_held=held,
         learner=[x["learner"] for x in epochs],
         episode_reward_mean=[x.get("episode_reward_mean") for x in epochs],
         evaluation=[x.get("evaluation") for x in epochs],
         launches={k: v for k, v in launches.items() if v})
    return launches


# ------------------------------------------------------------------ phases
def phase_device():
    require(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return kind, smi


def phase_build():
    t0 = time.monotonic()
    reports = kernels.build()
    seconds = time.monotonic() - t0
    summary = {name: [ln.strip() for ln in text.splitlines()
                      if "Used" in ln or "spill" in ln]
               for name, text in reports.items()}
    emit("build", seconds=seconds, built=sorted(reports),
         nvcc=kernels.nvcc_path(), ptxas=summary)


def phase_serve(model, params, requests, recorded, card):
    buckets = default_buckets(PAD_NODES, PAD_EDGES)
    fleet = build_fleet(model, params, device="cuda", buckets=buckets,
                        max_batch=MAX_BATCH, max_queue=len(requests),
                        deadline_s=0.002)
    server = fleet.replica_set.replicas[0].server
    # warm-up: one flush per bucket shape the fixture reaches (library
    # loads, allocator), outside the measured run
    for obs in requests[:MAX_BATCH]:
        fleet.submit(obs)
    fleet.drain()
    fleet.reset_stats()
    server = fleet.replica_set.replicas[0].server

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    ids, responses = [], []
    for obs in requests:
        ids.append(fleet.submit(obs))
        responses += fleet.poll()
    responses += fleet.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()

    by_id = {r.request_id: r for r in responses}
    require(sorted(by_id) == sorted(ids), "a request was dropped")
    require(all(r.source == "policy" for r in responses),
            f"non-policy answers: {[(r.source, r.reason) for r in responses if r.source != 'policy']}")
    require(not any(r.reason in ("degraded", "invalid") for r in responses),
            "degraded or invalid answers")
    require(not server.degraded, "the server latched degraded mode")
    actions = np.array([by_id[i].action for i in ids])
    require(np.array_equal(actions, recorded["jax_actions"]),
            "served actions differ from the recorded JAX actions")
    for name in KERNEL_SITES:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")
    require(not any(launches[name] for name in TRAIN_SITES),
            "serving launched a training kernel")
    summary = server.stats.summary()

    # logits on the same program shapes: batched forward vs the recorded
    # JAX logits, and batched vs one-at-a-time bit-equality
    forward = BucketForward(model, params, MAX_BATCH, device="cuda")
    bucketer = ObsBucketer(buckets)
    padded = [bucketer.bucket_obs(o) for o in requests]
    groups = {}
    for i, (idx, _) in enumerate(padded):
        groups.setdefault(idx, []).append(i)
    logits = np.zeros_like(recorded["jax_logits"])
    values = np.zeros_like(recorded["jax_values"])
    stack_s = run_s = 0.0
    n_batches = 0
    for members in groups.values():
        for start in range(0, len(members), MAX_BATCH):
            chunk = members[start:start + MAX_BATCH]
            t0 = time.monotonic()
            staged, n_real = forward.stack([padded[i][1] for i in chunk])
            t1 = time.monotonic()
            lo, va, ac = forward.run(staged, n_real)
            stack_s += t1 - t0
            run_s += time.monotonic() - t1
            n_batches += 1
            logits[chunk], values[chunk] = lo, va
            for k, i in enumerate(chunk):
                lo1, va1, ac1 = forward.forward([padded[i][1]])
                require(np.array_equal(lo1[0], lo[k])
                        and np.array_equal(va1[0], va[k])
                        and ac1[0] == ac[k],
                        f"request {i}: batched answer differs from the "
                        f"one-at-a-time answer")
    masked = recorded["jax_logits"] == np.finfo(np.float32).min
    require(np.array_equal(logits[masked], recorded["jax_logits"][masked]),
            "masked logits differ from the JAX ones")
    logit_err = float(np.abs(logits - recorded["jax_logits"]).max())
    value_err = float(np.abs(values - recorded["jax_values"]).max())
    require(logit_err <= 1e-4 and value_err <= 1e-4,
            f"logits/values off the JAX reference: {logit_err}, "
            f"{value_err}")

    # saturation: a 2-deep queue answers the overflow from the heuristic
    sat = build_fleet(model, params, device="cuda", buckets=buckets,
                      max_batch=MAX_BATCH, max_queue=2, deadline_s=10.0)
    sat_ids = [sat.submit(o) for o in requests]
    sat_resp = sat.poll() + sat.drain()
    rule = FixedDegreePacking(degree=8)
    fallback = [r for r in sat_resp if r.source == "fallback"]
    require(sorted(r.request_id for r in sat_resp) == sorted(sat_ids),
            "the saturation pass dropped a request")
    require(len(fallback) == len(requests) - 2
            and all(r.reason == "saturated"
                    and r.action == rule.compute_action(
                        requests[r.request_id]) for r in fallback),
            "saturation overflow was not answered by FixedDegreePacking")
    require(not any(r.reason in ("degraded", "invalid") for r in sat_resp),
            "degraded or invalid answers in the saturation pass")

    profiled = profile_serve(model, params, buckets, requests)

    emit("serve", card=card, n_requests=len(requests),
         requests_per_s=len(requests) / wall, wall_s=wall,
         host_stack_ms_per_flush=stack_s / n_batches * 1e3,
         run_ms_per_flush=run_s / n_batches * 1e3, profiled=profiled,
         p50_latency_ms=summary["p50_latency_ms"],
         p99_latency_ms=summary["p99_latency_ms"],
         n_flushes=summary["n_flushes"], program_shapes=summary["n_compiles"],
         launches=launches, logit_max_abs_err=logit_err,
         value_max_abs_err=value_err,
         saturation_fallbacks=len(fallback))
    return launches


def profile_serve(model, params, buckets, requests):
    """One more pass of the requests through a warmed fleet under
    torch.profiler: the card's kernel and copy time over the pass's wall
    time (the profiler's own host cost is inside that wall, so the busy
    share is a lower bound), and the largest device-time totals by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fleet = build_fleet(model, params, device="cuda", buckets=buckets,
                        max_batch=MAX_BATCH, max_queue=len(requests),
                        deadline_s=0.002)
    for obs in requests[:MAX_BATCH]:
        fleet.submit(obs)
    fleet.drain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for obs in requests:
            fleet.submit(obs)
            fleet.poll()
        fleet.drain()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time_total / 1e3)
    device_ms = sum(by_name.values())
    copy_ms = sum(v for k, v in by_name.items()
                  if k.startswith(("Memcpy", "Memset")))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "copy_ms": copy_ms, "device_busy_share": device_ms / wall_ms,
            "device_events": len(by_name),
            "top_device_ms": {k[:80]: v for k, v in top}}


def phase_cli(requests, recorded):
    lines = "".join(json.dumps({"id": f"req-{i}", "obs": {
        k: np.asarray(v).tolist() for k, v in requests[i].items()}}) + "\n"
        for i in range(MAX_BATCH))
    proc = subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.serve", "--params",
         EXPORT_PATH, "--deadline-ms", "5"], input=lines,
        capture_output=True, text=True, timeout=600, cwd=REPO)
    require(proc.returncode == 0, f"CLI exited {proc.returncode}: "
                                  f"{proc.stderr[-2000:]}")
    answers = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    require(len(answers) == MAX_BATCH, f"CLI answered {len(answers)} of "
                                       f"{MAX_BATCH} requests")
    got = {a["id"]: a for a in answers}
    for i in range(MAX_BATCH):
        a = got.get(f"req-{i}")
        require(a is not None and a["source"] == "policy"
                and a["action"] == int(recorded["jax_actions"][i]),
                f"CLI answer for req-{i}: {a}")
    emit("cli", n_requests=MAX_BATCH,
         stats=json.loads(proc.stderr.strip().splitlines()[-1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.set_grad_enabled(False)
    kind, card = phase_device()
    phase_build()

    model, params, _ = load_export(EXPORT_PATH)
    requests, recorded = load_requests()
    model_gpu = copy.deepcopy(model).to("cuda").eval()
    results = check_kernels(model_gpu, requests)
    emit("kernels_checked", card=card,
         **{name: {k: v for k, v in r.items() if k != "shapes"}
            for name, r in results.items()})

    fx = load_train_fixture()
    update_forward = check_update_forward_kernels(params, fx)
    emit("update_forward_kernels_checked", card=card,
         **{name: {k: v for k, v in r.items() if k != "shapes"}
            for name, r in update_forward.items()})
    train_results = check_train_kernels(params, requests, fx)
    emit("train_kernels_checked", card=card,
         **{name: {k: v for k, v in r.items() if k != "shapes"}
            for name, r in train_results.items()})

    rollout_fx = load_rollout_fixture()
    sample_result = check_sample_kernel(params, fx, rollout_fx["uniforms"])
    emit("sample_kernel_checked", card=card, mask_sample_logp={
        k: v for k, v in sample_result.items() if k != "shape"})

    ac_fx = load_ac_fixture()
    ac_results = check_ac_kernels(fx, ac_fx)
    emit("ac_kernels_checked", card=card,
         **{name: {k: v for k, v in r.items() if k != "shapes"}
            for name, r in ac_results.items()})

    dqn_es_fx = load_dqn_es_fixture()
    dqn_es_results = check_dqn_es_kernels(dqn_es_fx, fx, params)
    emit("dqn_es_kernels_checked", card=card, **dqn_es_results)

    heads_optim_results = check_heads_optim_kernels(params, fx)
    emit("heads_optim_kernels_checked", card=card, **heads_optim_results)

    lookahead_results = check_lookahead_kernel()
    emit("lookahead_kernel_checked", card=card, **lookahead_results)
    clusters = check_cluster_kernels(card)
    check_placement_kernel(card)
    k23_wide = check_wide_surfaces(card)

    launches = phase_serve(model, params, requests, recorded, card)
    phase_cli(requests, recorded)
    train_launches = phase_train(params, fx, card)
    rollout = phase_rollout(params, fx, rollout_fx["uniforms"], card)
    phase_eval(rollout_fx["eval"], card)
    loop_launches = phase_loop(card)
    ac_train_launches = phase_ac_train(params, fx, ac_fx, card)
    ac_loop_launches = phase_ac_loop(card)
    dqn_train_launches = phase_dqn_train(dqn_es_fx, fx, card)
    es_train_launches = phase_es_train(dqn_es_fx, params, card)
    dqn_es_loop_launches = phase_dqn_es_loop(card)
    pipeline_launches = phase_pipeline(params, fx, rollout_fx["uniforms"],
                                       rollout, card)
    ring_launches = phase_ring(card)
    lookahead_launches = phase_lookahead(
        params, lookahead_results["lookahead"]["groups"], card)
    lookahead_results["lookahead"]["hook_launches"] = phase_lookahead_hook(
        card)["lookahead"]
    phase_checkpoints(card)
    episode_results, episode_launches, block_launches = phase_episode(card)
    collect_results = phase_device_collect(card)
    phase_policy_episode(card)
    oracle_results, oracle_launches = phase_oracle(card)
    price_results, price_launches = phase_price_policy_episode(card)
    device_train_launches = phase_device_train(card)
    phase_scenario(card)
    scenario_results, scenario_launches = phase_scenario_episode(card)
    scenario_train_launches = phase_scenario_device_train(card)

    sample_result["shapes"] = [sample_result.pop("shape")]
    for r in (*dqn_es_results.values(), *heads_optim_results.values(),
              *lookahead_results.values()):
        r["shapes"] = [r.pop("shape")]
    rows = []
    for name, r in {**results, **train_results,
                    "mask_sample_logp": sample_result, **ac_results,
                    **dqn_es_results, **heads_optim_results,
                    **lookahead_results}.items():
        spec = kernels.KERNELS[name]
        forward = name in KERNEL_SITES
        sampling = name in SAMPLE_SITES
        actor_critic = name in AC_SITES
        dqn_es = name in DQN_ES_SITES
        pipeline = name in heads_optim_results
        engine = name in lookahead_results
        dqn_es_algo = "apex_dqn" if name.startswith("dqn") else "es"
        main_path = ("serve" if forward else
                     "rollout loop" if sampling else
                     "ac_loop" if actor_critic else
                     f"dqn_es_loop ({dqn_es_algo})" if dqn_es else
                     "pipeline" if pipeline else
                     "lookahead (rollout, jax pricing)" if engine else
                     "train_step")
        rows.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(spec.source, REPO),
            "replaces": spec.replaces,
            # the main path of each kernel: serving for the forward ones,
            # one 50-iteration train_step for the PPO update's, the PPO
            # training loop (2 epochs + 1 eval episode) for K9, the IMPALA
            # and PG loops (2 epochs each) for K10-K12, the DQN loop (3
            # epochs + 1 eval episode) for K13-K14 and the ES loop (2
            # epochs + 1 eval episode) for K15-K16
            # and the pipelined PPO loop (2 epochs, an evaluation each)
            # for K18-K20, the jax-pricing rollout for K21
            "launches": (launches[name] if forward else
                         loop_launches[name] if sampling else
                         ac_loop_launches[name] if actor_critic else
                         dqn_es_loop_launches[dqn_es_algo][name] if dqn_es
                         else pipeline_launches[name] if pipeline
                         else lookahead_launches[name] if engine
                         else train_launches[name]),
            "main_path": main_path,
            "train_step_launches": train_launches[name],
            "loop_launches": loop_launches[name],
            "ac_train_launches": {algo: n[name] for algo, n in
                                  ac_train_launches.items()},
            "ac_loop_launches": ac_loop_launches[name],
            "dqn_train_launches": dqn_train_launches[name],
            "es_train_launches": es_train_launches[name],
            "dqn_es_loop_launches": {algo: n[name] for algo, n in
                                     dqn_es_loop_launches.items()},
            "pipeline_launches": pipeline_launches[name],
            "ring_launches": ring_launches[name],
            "lookahead_launches": lookahead_launches[name],
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"],
            "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"],
            "composition_ms": r.get("composition_ms"),
            "composition_device_ms": r.get("composition_device_ms"),
            # the earlier entries this kernel's one launch took in
            "folds": r.get("folds"), "ms_by_ctas": r.get("ms_by_ctas"),
            "step_ms": r.get("step_ms"),
            "step_eager_ms": r.get("step_eager_ms"),
            "f64_ms": r.get("f64_ms"),
            # K2's plans, K20's plan and Ape-X DQN minibatch
            "plans": r.get("plans"), "plan": r.get("plan"),
            "rows_512": r.get("rows_512"),
            "cpp_engine_host_ms": r.get("cpp_engine_host_ms"),
            "hook_launches": r.get("hook_launches"),
            "calls": r.get("calls_per_forward", r.get("calls_per_step")),
            "calls_per": ("forward" if forward else "pricing decision"
                          if engine else "rollout step"
                          if sampling or name in ("dqn_act", "es_act")
                          else "update"
                          if name == "gae_normalize" or actor_critic
                          or dqn_es else "minibatch step"),
            "shapes": r["shapes"], "card": card})
        if engine:
            rows[-1]["cluster"] = clusters[name]
        if forward and name in update_forward:
            # the same kernel where the PPO update's forward runs it
            u = update_forward[name]
            rows[-1]["update"] = {
                "launches": train_launches[name],
                "calls": u["calls_per_forward"],
                "calls_per": "minibatch step",
                **{k: u[k] for k in ("max_abs_err", "ms", "eager_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_device_ms",
                                     "shapes")},
                "plans": u.get("plans")}
            if name == "ln_linear_act":
                rows.append({
                    **rows[-1], "name": "ln_linear_act (update)",
                    "launches": train_launches[name],
                    "main_path": "train_step",
                    **{k: u[k] for k in (
                        "max_abs_err", "max_rel_err", "ms", "eager_ms",
                        "plain_ms", "bound_ms", "bound_by", "library_ms",
                        "library_device_ms", "shapes")},
                    "kernel_ms": u["ms"], "calls": u["calls_per_forward"],
                    "calls_per": "minibatch step"})
                del rows[-1]["update"]
    for name, r in episode_results.items():
        spec = kernels.KERNELS[name]
        block = name == "first_fit_block"
        rows.append({
            # K21 on the episode, with skip, beside its row above
            "name": "lookahead (skip)" if name == "lookahead" else name,
            "route": "cuda", "source": os.path.relpath(spec.source, REPO),
            "replaces": spec.replaces,
            "launches": (block_launches if block else
                         episode_launches)[name],
            "main_path": ("block_search (the host episode's grids)" if block
                          else "episode (8 lanes, the float32 replay)"),
            "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "held_calls": r.get(
                "held_calls"),
            "ms": r["ms"], "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_device_ms": None, "calls": r["calls_per_step"],
            "calls_per": "split value" if block else "decision",
            "shapes": [r["shape"]], "card": card})
        if rows[-1]["name"] in clusters:
            rows[-1]["cluster"] = clusters[rows[-1]["name"]]
        if name == "allocate_job":
            rows[-1]["forms_device_ms"] = r["forms_device_ms"]
            # K23 where its tables come from global memory: [wide]'s 256
            # servers
            rows.append({
                **{k: v for k, v in rows[-1].items()
                   if k != "forms_device_ms"},
                "name": "allocate_job (global tables)",
                "launches": k23_wide["launches"],
                "launches_of": "[wide]'s own check, counted from 0 (256 "
                               "servers, fuzzed states); no main path "
                               "takes this form",
                "main_path": None,
                "max_abs_err": 0.0, "max_rel_err": 0.0,
                "held_calls": None, "ms": k23_wide["ms"],
                "kernel_ms": k23_wide["ms"],
                "eager_ms": k23_wide["eager_ms"],
                "plain_ms": k23_wide["plain_ms"],
                "bound_ms": k23_wide["bound"][0],
                "bound_by": k23_wide["bound"][1], "calls": 1,
                "calls_per": "launch", "shapes": [k23_wide["shape"]]})
    for name, r in collect_results.items():
        spec = kernels.KERNELS[name]
        rows.append({
            # K25 with the reset, beside its replay row above
            "name": "episode_step (reset)" if name == "episode_step"
            else name,
            "route": "cuda", "source": os.path.relpath(spec.source, REPO),
            "replaces": ("ddls_tpu/sim/jax_env.py:1596" if name ==
                         "episode_step" else spec.replaces),
            "launches": device_train_launches[name],
            "main_path": "device_train (2 epochs x 2 lanes x 128 steps)",
            "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "held_calls": r["held_calls"],
            "reset_calls_held": r.get("reset_calls_held"),
            "ms": r["ms"], "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_device_ms": None, "calls": r["calls_per_step"],
            "calls_per": "collection step", "shapes": [r["shape"]],
            "card": card})
    for results, launched, main_path in (
            (oracle_results, oracle_launches,
             "oracle (8 lanes, the float32 OracleJCT episode)"),
            (price_results, price_launches,
             "price_policy_episode (ppo_price_mixed greedy, float64)")):
        for name, r in results.items():
            spec = kernels.KERNELS[name]
            rows.append({
                "name": name, "route": "cuda",
                "source": os.path.relpath(spec.source, REPO),
                "replaces": spec.replaces, "launches": launched[name],
                "main_path": main_path, "max_abs_err": r["max_abs_err"],
                "max_rel_err": r["max_rel_err"],
                "held_calls": r["held_calls"], "ms": r["ms"],
                "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "library_device_ms": None, "calls": r["calls_per_step"],
                "calls_per": "step", "shapes": [r["shape"]], "card": card})
    for name, r in scenario_results.items():
        spec = kernels.KERNELS[name]
        rows.append({
            # K25 with the failure walk, beside its nominal rows above
            "name": name, "route": "cuda",
            "source": os.path.relpath(spec.source, REPO),
            "replaces": spec.replaces, "launches": scenario_launches[name],
            "main_path": "scenario_episode (8 lanes, the float32 replay)",
            "scenario_device_train_launches": scenario_train_launches[name],
            "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "held_calls": r["held_calls"],
            "ms": r["ms"], "kernel_ms": r["ms"], "eager_ms": r["eager_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_device_ms": None, "calls": 1, "calls_per": "decision",
            "shapes": [r["shape"]], "card": card})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
