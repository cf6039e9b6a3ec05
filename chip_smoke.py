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
   (abs and rel 1e-5; K2 and K4 also bitwise across two runs) and times
   the kernel, the plain version and a one-call PyTorch yardstick.
   Then K5–K8, the PPO update's kernels: every backward-kernel call of one
   minibatch step of the training fixture (128 real graphs at the (38,
   128) bucket), of one forward + backward of the edge-case batch at (150,
   512) (plus a node row whose LayerNorm variance clamps at exactly 0),
   the GAE of the fixture trajectory and the loss of the minibatch; each
   held against its plain version (abs 1e-5 of each output's own largest
   magnitude: float32 sums over up to 16,384 rows in another order; K5's
   plain version takes relu's kink decisions from K1's output on the same
   inputs), bitwise across two runs, and timed as above.
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

Phase 3 also holds K17 (both heads; recorded in the forward like K1–K4),
K18 (the heads' backward and its reduce), K19 (the optimiser's three
launches, the clip firing, not firing and at a tie) and K20 (the
minibatch assembly, exactly) against their plain versions, and K21 (the
array lookahead engine) on the recorded lanes in float32 and float64:
bit-equal to its plain version and, in float32, to the recorded JAX
answers; within 1e-9 of the C++ engine in float64.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import copy
import ctypes
import json
import os
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
# use_jax_lookahead, candidate_pricing="jax") and the device episode
# replay (K21-K25) launch them, no learner's path
SIM_KERNELS = ("lookahead", "first_fit_block", "allocate_job",
               "price_and_score", "episode_step")
TIMED_ITERS = 200


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    launch cost drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def check_kernels(model_gpu, requests):
    """Phase 3: per kernel, max error over both buckets and its times at
    the largest bucket (summed over the calls of one forward)."""
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "ms": 0.0,
                      "eager_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                      "library_device_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": None, "calls_per_forward": 0,
                      "shapes": []}
               for name in KERNEL_SITES}
    buckets = default_buckets(PAD_NODES, PAD_EDGES)
    for timed, (n_pad, e_pad) in ((True, buckets[-1]), (False, buckets[0])):
        batch = edge_case_batch(requests, n_pad, e_pad)
        calls = record_calls(model_gpu, batch)
        for name, recorded in calls.items():
            require(len(recorded) > 0, f"forward made no {name} call")
            res = results[name]
            parts = KERNEL_SITES[name][2]
            bound_total = {"bytes": 0.0, "operations": 0.0}
            for fn, args, kwargs in recorded:
                plain, library, (bound, bound_by), shape = parts(args,
                                                                 kwargs)
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
                    require(all(torch.equal(x, y)
                                for x, y in zip(outs, agains)),
                            f"{name} is not bitwise repeatable")
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
    # b is given) and the parameter gradients; K5's per-block partials are
    # its own intermediate (the reduce's row counts them)
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


def k5r_parts(args, kwargs):
    (partial,) = args
    return (lambda: gnn_mod.ln_linear_act_bwd_reduce_plain(partial),
            lambda: partial.sum(dim=0),
            bound_ms(_nbytes(partial) + partial.shape[1] * 4,
                     partial.numel()),
            f"blocks={partial.shape[0]} params={partial.shape[1]}")


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
    "ln_linear_act_bwd_reduce": (gnn_mod, "ln_linear_act_bwd_reduce",
                                 k5r_parts),
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
                out = fn(*args, **kwargs)
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
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time_total / 1e3)
    device_ms_total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": n_steps, "wall_ms": wall_ms,
            "device_ms": device_ms_total,
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
                         "ln_linear_act_bwd", "ln_linear_act_bwd_reduce",
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
                 "ln_linear_act_bwd_reduce", "csr_segment_mean_bwd",
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
    epochs, rollout_length cut to 50; from the shipped export), each with
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
                cfg["epoch_loop"]["rollout_length"] = 50
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
                     "ln_linear_act_bwd_reduce", "csr_segment_mean_bwd",
                     "csr_segment_sum", "masked_mean_pool_concat_bwd")
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


def _clip_adam_entries(state, grads, hp):
    """K19's three launches one at a time, with the wrapper's arguments
    (the leaf table built as the wrapper builds it)."""
    opt = learner_mod._optimizer_table(state)
    n = len(state.params)
    grad_table = (ctypes.c_int64 * n)(*(g.data_ptr() for g in grads))
    partial = state.params[0].new_zeros(n * opt.chunks)
    norm = state.params[0].new_zeros(1)
    f32 = np.float32

    def norm_pass():
        kernels.launch("clip_adam_norm", ctypes.addressof(grad_table),
                       opt.table.data_ptr(), partial.data_ptr(), n,
                       opt.chunks)

    def reduce_pass():
        kernels.launch("clip_adam_reduce", partial.data_ptr(),
                       norm.data_ptr(), partial.numel())

    def update_pass():
        kernels.launch("clip_adam_update", ctypes.addressof(grad_table),
                       opt.table.data_ptr(), norm.data_ptr(), n, opt.chunks,
                       0, float(hp.grad_clip), hp.lr, hp.b1,
                       float(f32(1.0 - hp.b1)), hp.b2,
                       float(f32(1.0 - hp.b2)), hp.eps, hp.bc1, hp.bc2)

    return norm_pass, reduce_pass, update_pass, partial


def check_heads_optim_kernels(params, fx):
    """Phase 3, K18–K20 on the training fixture's first minibatch step (128
    rows at the (38, 128) bucket, the shipped heads 24 -> 17 -> {17, 1}):
    K18 (the heads' backward and its block-order reduce) against autograd
    of the plain heads, also on the Ape-X DQN's heads (24 -> 256 -> {17, 1}
    at 512 rows), the default (256, 256) heads and one row; K19 (the global
    norm, its reduce, the clipped adam update) against the plain optimiser
    over five steps of the shipped policy's 36 leaves with the clip not
    firing, firing, and at a norm within rounding of the clip; K20 (the
    minibatch assembly) against its plain version and
    ``prepare_flat_batch``'s arrays on the minibatch, repeated samples, one
    sample and the full batch, exactly. Every float within 1e-5 of each
    output's largest magnitude, every kernel bitwise across two runs, and
    timed at the minibatch step's shapes."""
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
    for case in (idx, torch.as_tensor(rng.integers(0, n, 128),
                                      device="cuda"),
                 idx[:1].clone(), learner._positions(n)):
        out = learner_mod.minibatch_gather(staged.tensors, case,
                                           staged.n_nodes, staged.n_edges)
        again = learner_mod.minibatch_gather(staged.tensors, case,
                                             staged.n_nodes, staged.n_edges)
        plain = learner_mod.minibatch_gather_plain(
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
    m = idx.shape[0]
    per_sample = sum(t[0].numel() * t.element_size() for t in (
        staged["node_features"], staged["edge_features"],
        staged["graph_features"], staged["action_mask"],
        staged["node_mask"], staged["structure"]))
    out = learner_mod.minibatch_gather(staged.tensors, idx, staged.n_nodes,
                                       staged.n_edges)
    written = sum(t.numel() * t.element_size() for t in out.values())
    bound, bound_by = bound_ms(m * per_sample + _nbytes(idx) + written,
                               0.0)

    def gather():
        return learner_mod.minibatch_gather(staged.tensors, idx,
                                            staged.n_nodes, staged.n_edges)

    def gather_plain():
        return learner_mod.minibatch_gather_plain(
            staged.tensors, idx, staged.n_nodes, staged.n_edges)

    res.update(shape=f"samples={m} of {n} nodes={staged.n_nodes} "
                     f"edges={staged.n_edges}",
               bound_ms=bound, bound_by=bound_by, ms=device_ms(gather),
               eager_ms=eager_ms(gather),
               plain_ms=eager_ms(gather_plain, iters=20))
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
                                  ((17,), 1, 4)):
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
    res.update(shape=f"rows={x.shape[0]} in={x.shape[1]} logit="
                     f"{[w.shape[0] for w, _ in logit_layers]} value="
                     f"{[w.shape[0] for w, _ in value_layers]}",
               bound_ms=bound, bound_by=bound_by,
               ms=device_ms(lambda: policy_mod.mlp_heads_bwd(*main_case)),
               eager_ms=eager_ms(lambda: policy_mod.mlp_heads_bwd(
                   *main_case)),
               plain_ms=eager_ms(lambda: policy_mod.mlp_heads_bwd_plain(
                   *main_case), iters=20),
               library_ms=eager_ms(library_bwd, iters=50),
               library_device_ms=profiled_device_ms(library_bwd))
    results["mlp_heads_bwd"] = res
    # its block-order reduce alone, on the main case's partial sums
    n_params = sum(w.numel() + b.numel()
                   for w, b in logit_layers + value_layers)
    blocks = max(1, min(-(-x.shape[0] // policy_mod._HEAD_BWD_TILE),
                        policy_mod._HEAD_BWD_MAX_BLOCKS))
    partial = torch.randn(blocks, n_params, generator=g).cuda()
    reduced = partial.new_empty(n_params)

    def reduce():
        kernels.launch("mlp_heads_bwd_reduce", partial.data_ptr(),
                       reduced.data_ptr(), blocks, n_params)
        return reduced

    out = reduce().clone()
    ref = gnn_mod.ln_linear_act_bwd_reduce_plain(partial)
    torch.cuda.synchronize()
    require(torch.equal(out, reduce()), "mlp_heads_bwd_reduce is not "
                                        "bitwise repeatable")
    err, rel = max_err_scaled(out, ref)
    bound, bound_by = bound_ms(_nbytes(partial) + n_params * 4,
                               blocks * n_params)
    results["mlp_heads_bwd_reduce"] = _new_result(
        max_abs_err=err, max_rel_err=rel,
        shape=f"blocks={blocks} params={n_params}", bound_ms=bound,
        bound_by=bound_by, ms=device_ms(reduce), eager_ms=eager_ms(reduce),
        plain_ms=eager_ms(lambda: gnn_mod.ln_linear_act_bwd_reduce_plain(
            partial), iters=20),
        library_ms=eager_ms(lambda: partial.sum(dim=0)),
        library_device_ms=device_ms(lambda: partial.sum(dim=0)))

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

    res = {name: _new_result() for name in ("clip_adam_norm",
                                            "clip_adam_reduce",
                                            "clip_adam_update")}
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
    norm_pass, reduce_pass, update_pass, partial = _clip_adam_entries(
        st, grads, hp)
    n_el = sum(p.numel() for p in st.params)
    n_leaves = len(st.params)
    lib_params = [torch.nn.Parameter(p.detach().clone())
                  for p in st.params]
    for p, gr in zip(lib_params, grads):
        p.grad = gr.clone()
    adam = torch.optim.Adam(lib_params, lr=cfg.lr, fused=True)

    def library_norm():
        return torch.nn.utils.clip_grad_norm_(lib_params, cfg.grad_clip,
                                              foreach=True)

    def library_step():
        torch.nn.utils.clip_grad_norm_(lib_params, cfg.grad_clip,
                                       foreach=True)
        adam.step()

    plain_p, plain_mu, plain_nu = copies(st)

    def plain_step():
        learner_mod.clip_adam_plain(plain_p, grads, plain_mu, plain_nu, hp)

    def plain_norm():
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    shape = f"leaves={n_leaves} params={n_el}"
    for name, fn, nbytes, ops in (
            ("clip_adam_norm", norm_pass, 4 * n_el + partial.numel() * 4,
             2 * n_el),
            ("clip_adam_reduce", reduce_pass, partial.numel() * 4 + 4,
             partial.numel()),
            ("clip_adam_update", update_pass, 7 * 4 * n_el + 4,
             16 * n_el)):
        bound, bound_by = bound_ms(nbytes, ops)
        res[name].update(shape=shape, bound_ms=bound, bound_by=bound_by,
                         ms=device_ms(fn), eager_ms=eager_ms(fn),
                         max_abs_err=opt_err, max_rel_err=opt_rel)
    res["clip_adam_norm"].update(
        plain_ms=eager_ms(plain_norm, iters=20),
        library_ms=eager_ms(library_norm, iters=50),
        library_device_ms=profiled_device_ms(library_norm))
    res["clip_adam_reduce"].update(
        plain_ms=eager_ms(lambda: torch.sqrt(partial.sum()), iters=20))
    step_state = fresh_state()
    res["clip_adam_update"].update(
        step_ms=device_ms(lambda: learner_mod.clip_adam(step_state, grads,
                                                        hp)),
        step_eager_ms=eager_ms(lambda: learner_mod.clip_adam(
            step_state, grads, hp)),
        plain_ms=eager_ms(plain_step, iters=20),
        library_ms=eager_ms(library_step, iters=50),
        library_device_ms=profiled_device_ms(library_step))
    results.update(res)
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
                 "clip_adam_update", "minibatch_gather", "mask_sample_logp"):
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


def _profile_episode(et, fx, dtype, lanes):
    """The recorded banks ``lanes`` replayed twice, decision by decision as
    ``make_episode_fn`` runs them. The first run records what the bounds
    count: each decision's config rows, active lanes, K21 ticks, accepts
    and completions. The second, identical but for that recording, runs
    under torch.profiler: device time per kernel, the device operations
    (kernels, copies, fills) per decision, and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run(None)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name, count = {}, {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            by_name[event.name] = (by_name.get(event.name, 0.0)
                                   + event.device_time_total / 1e3)
            count[event.name] = count.get(event.name, 0) + 1
    kernel_ms, kernel_ops = {}, {}
    for name in EPISODE_KERNELS:
        mine = [k for k in by_name if f"{name}_kernel<" in k]
        kernel_ms[name] = sum(by_name[k] for k in mine)
        kernel_ops[name] = sum(count[k] for k in mine) / D
    others = sorted(((n, v) for n, v in count.items()
                     if not any(f"{k}_kernel<" in n
                                for k in EPISODE_KERNELS)),
                    key=lambda x: -x[1])
    device_total = sum(by_name.values())
    stacked = [torch.stack([c[i] for c in calls]).cpu().numpy()
               for i in range(6)]                                # [D, B]
    return {"wall_ms": wall_ms, "device_ms": device_total,
            "busy_share": device_total / wall_ms,
            "kernel_device_ms": kernel_ms,
            "other_device_ms": device_total - sum(kernel_ms.values()),
            "device_ops_per_decision": sum(count.values()) / D,
            "kernel_launches_per_decision": kernel_ops,
            "other_device_ops_per_decision": {
                n[:60]: c / D for n, c in others[:6]},
            "decisions": D, "lanes": len(lanes), "cfg": stacked[0],
            "active": stacked[1], "ticks": stacked[2],
            "accept": stacked[4], "completions": stacked[5] - stacked[3]}


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
    N, M, F, P = pads.n_ops, pads.n_deps, pads.n_fwd, pads.n_parents
    G, Eg, Sy, O = pads.n_groups, pads.group_edges, pads.n_sync, pads.n_o2o
    S, C, R = et.n_srv, et.n_chan, et.n_srv
    st = et.st
    cfg, active = prof["cfg"], prof["active"].astype(np.float64)
    ticks, accept = prof["ticks"], prof["accept"].astype(np.float64)
    completions = prof["completions"].astype(np.float64)
    D, B = cfg.shape
    n_valid = tb["n_ops"][cfg]
    m_valid = tb["n_deps"][cfg]
    # K23: the config rows of each valid forward op (its sub-ops up to its
    # split), and per launch each shape row the deciding lanes' ops use,
    # with the anchors and cells of its shapes' origin spans
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
    k23_rows = 0.0
    for d in range(D):
        used = np.unique(split_row[cfg[d]][
            tb["f_valid"][cfg[d]] & (active[d] > 0)[:, None]])
        k23_rows += row_bytes[used].sum()
    k23_bytes = k23_rows + float(np.sum(active * (
        4 + S * (fb + 1) + f_bytes[cfg] + 4 * n_valid + S * fb + 1)))
    k23_ops = float(np.sum(active * op_tests[cfg]))
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
    deciding = (M + 4 * m_valid + N + 4 * n_valid + S * fb + 2 * fb + 7
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
    emit("episode_host_env", card=card, decisions=len(decisions),
         host_episode_s=host_s, t_jct_max_rel_err=rel, causes=causes,
         **stats)
    return np.stack(grids), et


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
    c = state["cfg"].long()
    T = dev.t
    valid = T["op_valid"][c]
    la_args = (T["op_compute"][c], valid, torch.where(valid, raw["ots"], -1),
               raw["op_score"], T["num_parents"][c], raw["times"],
               T["dep_valid"][c], T["dep_src"][c], T["dep_dst"][c],
               T["dep_mutual"][c], raw["is_flow"], raw["dep_score"],
               raw["chan"][:, :, None])
    la_kw = dict(num_workers=et.n_srv, num_channels=et.n_chan,
                 skip=~state["active"])
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
        "lookahead": lambda: lookahead_mod.lookahead_plain(*la_args,
                                                           **la_kw),
        "episode_step": step_plain}
    free0 = state["srv_job"] < 0
    eager = {
        "allocate_job": eager_ms(lambda: device_env.allocate_job(
            state["mem"], free0, state["cfg"], dev)),
        "price_and_score": eager_ms(lambda: device_env.price_and_score(
            raw["ots"], state["cfg"], dev)),
        "lookahead": eager_ms(lambda: lookahead_mod.lookahead(
            *la_args, **la_kw), iters=20)}
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
    for name in EPISODE_KERNELS:
        r = results[name]
        r.update(ms=prof["kernel_device_ms"][name] / D,
                 eager_ms=eager[name], bound_ms=bounds[name][0],
                 bound_by=bounds[name][1],
                 plain_ms=eager_ms(plain[name],
                                   iters=1 if name == "lookahead" else 3),
                 shape=(f"episode: lanes=8 decisions={D} N={et.pads.n_ops} "
                        f"M={et.pads.n_deps} configs={dev.n_cfg} "
                        f"servers={et.n_srv} channels={et.n_chan} float32"))
    emit("episode_profile", card=card, decisions=D, lanes=8,
         wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
         device_busy_share=prof["busy_share"],
         device_ms_per_decision={k: v / D for k, v in
                                 prof["kernel_device_ms"].items()},
         other_device_ms_per_decision=prof["other_device_ms"] / D,
         k21_ticks_per_lane_decision=float(prof["ticks"].sum()) / (
             D * prof["lanes"]),
         k21_slowest_lane_ticks_per_decision=float(
             prof["ticks"].max(1).mean()),
         device_ops_per_decision=prof["device_ops_per_decision"],
         kernel_launches_per_decision=prof[
             "kernel_launches_per_decision"],
         other_device_ops_per_decision=prof[
             "other_device_ops_per_decision"],
         bound_ms_per_call={k: v[0] for k, v in bounds.items()},
         bound_bytes_per_call={k: v[2] for k, v in bounds.items()},
         bound_ops_per_call={k: v[3] for k, v in bounds.items()})

    grids, host_et = _host_episode(card)
    bs_results, bs_launches = phase_block_search(grids, host_et, card)
    results.update(bs_results)
    return results, launches, bs_launches


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
            "step_ms": r.get("step_ms"),
            "step_eager_ms": r.get("step_eager_ms"),
            "f64_ms": r.get("f64_ms"),
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
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
