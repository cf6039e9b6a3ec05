"""What the port's learners share: the train state, the staged
trajectory, acting, on-device batch assembly and the optimiser.

``PPOLearner`` (``rl/ppo.py``), ``ImpalaLearner`` (``rl/impala.py``),
``PGLearner`` (``rl/pg.py``), ``ApexDQNLearner`` (``rl/dqn.py``) and
``ESLearner`` (``rl/es.py``) subclass ``Learner``, which holds the parts
the reference repeats in each of ``ddls_tpu/rl/{ppo,impala,pg,dqn,es}.py``:

* acting: ``device_batch``, ``sample_actions`` (the forward and K9),
  ``values``, ``greedy_actions`` (K4);
* staging: ``stage_traj`` copies a host trajectory to the device once,
  with every sample's flattened-graph arrays and both CSRs built on the
  host (``models/policy.py`` ``sample_structure``); ``minibatch`` gathers
  samples, offsets them and concatenates their CSRs in one launch of K20
  (``models/policy.py`` ``minibatch_gather``), with no host round trip;
* the optimiser: optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``
  (adam alone where ``grad_clip`` is None, as ES's) or, for
  IMPALA's ``opt_type: rmsprop``, ``chain(clip_by_global_norm,
  rmsprop(lr, decay, eps, momentum))``, in optax's arithmetic, as K19
  (``clip_adam``: one launch over every leaf).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.models.policy import (GRAD_INPUT_KEYS, GNNPolicy,
                                          minibatch_gather,
                                          prepare_flat_batch,
                                          sample_structure)
from ddls_tpu_torch.serve.bucketing import default_buckets
from ddls_tpu_torch.serve.server import resolve_device

# optax.adam's defaults (the reference's learners take optax.adam(lr))
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# algo_config keys that an epoch loop consumes, not a learner
LOOP_LEVEL_ALGO_KEYS = {"num_workers", "device_collector",
                        "device_bank_jobs", "use_jax_lookahead_memo"}


def reject_unknown_algo_keys(algo_name: str, keys, known) -> None:
    """Raise on ``algo_config`` keys that nothing consumes
    (``ddls_tpu/train/loops.py:59``), so a swept hyperparameter can never
    be a silent no-op."""
    unknown = sorted(set(keys) - set(known) - LOOP_LEVEL_ALGO_KEYS)
    if unknown:
        raise ValueError(
            f"{algo_name} algo_config keys {unknown} are not consumed; "
            f"remove them. Known keys: "
            f"{sorted(set(known) | LOOP_LEVEL_ALGO_KEYS)}")


@dataclasses.dataclass
class TrainState:
    """The learner's state. ``params`` are the learner's model's own
    parameters, updated in place by ``train_step`` (a later ``init_state``
    overwrites them), in ``names`` order. ``nu`` is adam's or rmsprop's
    second moment; ``mu`` adam's first moment, or rmsprop's momentum trace
    (None where rmsprop's momentum is 0: the trace is then the update
    itself); ``kl_coeff`` PPO's adaptive KL coefficient, a float32 scalar
    on the device (float32 as in the JAX ``TrainState``), None for the
    other learners; ``target_params`` DQN's target network's parameters
    (None for the other learners); ``step`` counts optimiser steps."""
    names: List[str]
    params: List[torch.Tensor]
    mu: Optional[List[torch.Tensor]]
    nu: List[torch.Tensor]
    kl_coeff: Optional[torch.Tensor] = None
    step: int = 0
    target_params: Optional[List[torch.Tensor]] = None
    # K19's host table of the leaves and its launch plan (``clip_adam``),
    # built at the first step on the card
    opt_table: Optional[Any] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach() for n, p in zip(self.names, self.params)}


# ------------------------------------------------------- staged trajectory
TRAJ_OBS_KEYS = ("node_features", "edge_features", "graph_features",
                 "edges_src", "edges_dst", "node_split", "edge_split",
                 "action_mask")


def trim_bucket(node_split: np.ndarray, edge_split: np.ndarray,
                max_nodes: int, max_edges: int) -> Tuple[int, int]:
    """The smallest bucket of the serving ladder (``default_buckets`` of
    the pad bounds) that holds every sample's real nodes and edges. Padded
    rows get zero gradient and never reach a real row, so a trajectory
    trimmed to it trains the same real rows as at the full pad."""
    n_real = int(np.max(node_split)) if np.size(node_split) else 0
    e_real = int(np.max(edge_split)) if np.size(edge_split) else 0
    for n, e in default_buckets(max_nodes, max_edges):
        if n >= n_real and e >= e_real:
            return n, e
    return max_nodes, max_edges


@dataclasses.dataclass
class StagedTraj:
    """A trajectory on the learner's device (``Learner.stage_traj``):
    per-sample rows in the B-major order of the reference's ``to_rows``
    (row = b * T + t), the [T, B] reward/value/done arrays, and each
    sample's flattened-graph structure, at the bucket (n_nodes, n_edges)."""
    tensors: Dict[str, torch.Tensor]
    t_len: int
    lanes: int
    n_nodes: int
    n_edges: int

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.tensors[key]


def pack_to_device(arrays: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """Every array in one pinned byte buffer, one host-to-device copy, then
    a typed view per array."""
    layout, offset = [], 0
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        offset = -(-offset // 8) * 8
        layout.append((name, arr, offset))
        offset += arr.nbytes
    host = torch.empty(max(offset, 1), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    flat = host.numpy()
    for _, arr, off in layout:
        flat[off:off + arr.nbytes] = arr.view(np.uint8).reshape(-1)
    dev = host.to(device, non_blocking=True)
    out = {}
    for name, arr, off in layout:
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        out[name] = dev[off:off + arr.nbytes].view(dtype).view(arr.shape)
    return out


def rows_to_tb(x: torch.Tensor, traj: StagedTraj) -> torch.Tensor:
    """B-major rows [B*T] (row = b * T + t) -> a contiguous [T, B]."""
    return x.reshape(traj.lanes, traj.t_len).t().contiguous()


def tb_to_rows(x: torch.Tensor) -> torch.Tensor:
    """[T, B] -> B-major rows [B*T] (the reference's ``to_rows``; the
    reshape of the transpose is a contiguous copy)."""
    return x.t().reshape(-1)


# ----------------------------------------------------- K19: the optimiser
@dataclasses.dataclass(frozen=True)
class OptimizerStep:
    """One optimiser step's hyperparameters. ``rule`` is ``"adam"``,
    ``"rmsprop"`` or ``"rmsprop_momentum"``; ``b1`` is adam's b1 or
    rmsprop's momentum, ``b2`` adam's b2 or rmsprop's decay; ``bc1`` and
    ``bc2`` adam's bias corrections (``Learner._bias_correction``);
    ``grad_clip`` None for no clip."""
    rule: str
    lr: float
    grad_clip: Optional[float]
    b1: float
    b2: float
    eps: float
    bc1: float = 1.0
    bc2: float = 1.0


def clip_adam_plain(params: List[torch.Tensor], grads: List[torch.Tensor],
                    mu: Optional[List[torch.Tensor]], nu: List[torch.Tensor],
                    hp: OptimizerStep) -> None:
    """K19's plain version, with ``torch._foreach_*`` calls in optax's
    arithmetic, in place. The clip keeps ``g`` where the global norm is
    below ``grad_clip``, else takes ``g / norm * grad_clip`` (chosen on the
    device). adam: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2
    nu``, ``update = (mu / bc1) / (sqrt(nu / bc2) + eps)``. rmsprop
    (``scale_by_rms`` with eps inside the root, then ``-lr``, then
    ``trace``): ``nu = (1 - decay) g^2 + decay nu``, ``update = -lr g
    rsqrt(nu + eps)``, and with momentum ``trace = update + momentum
    trace``. Last, ``p += update``."""
    if hp.grad_clip is not None:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < hp.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        grads = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(
            keep, one, torch.full_like(one, hp.grad_clip)))
    if hp.rule == "adam":
        scaled = torch._foreach_mul(grads, 1.0 - hp.b1)
        torch._foreach_mul_(mu, hp.b1)
        torch._foreach_add_(mu, scaled)
        squared = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squared, 1.0 - hp.b2)
        torch._foreach_mul_(nu, hp.b2)
        torch._foreach_add_(nu, squared)
        mu_hat = torch._foreach_div(mu, hp.bc1)
        denom = torch._foreach_div(nu, hp.bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, hp.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -hp.lr)
    else:
        squared = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squared, 1.0 - hp.b2)
        torch._foreach_mul_(nu, hp.b2)
        torch._foreach_add_(nu, squared)
        scale = torch._foreach_add(nu, hp.eps)
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(scale, grads)
        torch._foreach_mul_(updates, -hp.lr)
        if hp.rule == "rmsprop_momentum":
            torch._foreach_mul_(mu, hp.b1)
            torch._foreach_add_(mu, updates)
            updates = mu
    torch._foreach_add_(params, updates)


# K19's limits (kernels/csrc/clip_adam.cu): leaves, elements of a job (a
# leaf's chunk: the norm's order of sums is cut at it), CTAs a cluster; the
# elements one CTA takes before the plan adds another (the update's chains
# of dependent divisions want the elements spread over SMs), and the shared
# memory a CTA may take (of the H100's 232,448 bytes): its jobs' offsets
# and every job's partial
_OPT_MAX_LEAVES, _OPT_CHUNK, _OPT_MAX_CTAS = 96, 1024, 16
_OPT_CTA_ELEMENTS, _OPT_SMEM = 768, 224 * 1024
_OPT_RULES = {"adam": 0, "rmsprop": 1, "rmsprop_momentum": 2}


@dataclasses.dataclass(frozen=True)
class OptimizerPlan:
    """K19's launch over leaves of ``sizes``: ``chunks`` jobs a leaf (the
    largest leaf's count of ``_OPT_CHUNK``-element chunks; the norm's flat
    job index is ``leaf * chunks + chunk``), one cluster of ``ctas`` CTAs,
    CTA r taking the flat jobs ``[bounds[r], bounds[r + 1])``."""
    chunks: int
    ctas: int
    bounds: Tuple[int, ...]


def job_sizes(sizes: List[int], chunks: int) -> List[int]:
    """The elements of each flat job (``leaf * chunks + chunk``)."""
    return [max(0, min(_OPT_CHUNK, size - c * _OPT_CHUNK))
            for size in sizes for c in range(chunks)]


def clip_adam_plan(sizes: List[int],
                   ctas: Optional[int] = None) -> OptimizerPlan:
    """K19's plan for leaves of ``sizes`` elements: ``ctas`` CTAs
    (default one per ``_OPT_CTA_ELEMENTS`` elements, at most
    ``_OPT_MAX_CTAS``), the flat jobs cut into contiguous runs balanced by
    elements (each CTA's run ends at the first job that brings it to its
    share of the total); raises where a CTA's jobs' offsets and every
    job's partial do not fit ``_OPT_SMEM``."""
    if not 0 < len(sizes) <= _OPT_MAX_LEAVES:
        raise ValueError(f"K19 takes 1 to {_OPT_MAX_LEAVES} leaves, got "
                         f"{len(sizes)}")
    chunks = max(1, -(-max(sizes) // _OPT_CHUNK))
    jobs = job_sizes(sizes, chunks)
    total = sum(jobs)
    if ctas is None:
        ctas = max(1, min(_OPT_MAX_CTAS, -(-total // _OPT_CTA_ELEMENTS)))
    if not 1 <= ctas <= _OPT_MAX_CTAS:
        raise ValueError(f"K19 takes 1 to {_OPT_MAX_CTAS} CTAs, got {ctas}")
    bounds, acc = [0], 0
    for j, n in enumerate(jobs):
        acc += n
        while len(bounds) < ctas and acc * ctas >= total * len(bounds):
            bounds.append(j + 1)
    bounds += [len(jobs)] * (ctas + 1 - len(bounds))
    most = max(b - a for a, b in zip(bounds, bounds[1:]))
    if 4 * (most + 1 + len(jobs)) > _OPT_SMEM:
        raise ValueError(f"K19's {len(jobs)} jobs over {ctas} CTAs do not "
                         f"fit a CTA's shared memory")
    return OptimizerPlan(chunks, ctas, tuple(bounds))


@dataclasses.dataclass
class OptimizerTable:
    """K19's host table of a train state's leaves: int64 [4 L + ctas + 1],
    the parameter, mu (0 without) and nu pointers, the sizes and the
    plan's job bounds, keyed by the pointers it was built from
    (``clip_adam`` rebuilds it when a leaf's storage moves)."""
    key: Tuple[int, ...]
    table: Any  # a ctypes int64 array
    plan: OptimizerPlan


def _optimizer_table(state: "TrainState",
                     ctas: Optional[int] = None) -> OptimizerTable:
    """The state's cached table of ``clip_adam_plan``'s own plan, or with
    ``ctas`` a table of that many CTAs that is not cached."""
    mu = state.mu or [None] * len(state.params)
    key = tuple(t.data_ptr() if t is not None else 0
                for t in (*state.params, *mu, *state.nu))
    cached = state.opt_table
    if ctas is None and cached is not None and cached.key == key:
        return cached
    sizes = [p.numel() for p in state.params]
    plan = clip_adam_plan(sizes, ctas)
    host = list(key) + sizes + list(plan.bounds)
    table = OptimizerTable(key, (ctypes.c_int64 * len(host))(*host), plan)
    if ctas is None:
        state.opt_table = table
    return table


def clip_adam(state: "TrainState", grads: List[torch.Tensor],
              hp: OptimizerStep) -> None:
    """K19: the optimiser step ``hp`` over every leaf of ``state`` with
    ``grads`` (same shapes), in place, in one launch and no host round
    trip: the global norm (only with a clip), the clip decision, the
    moments and the update per element (``kernels/csrc/clip_adam.cu``;
    the CTAs are ``clip_adam_plan``'s, or ``kernels.forced("clip_adam")``'s
    in a test). On the CPU, ``clip_adam_plain``."""
    if kernels.on_cpu(*state.params, *grads):
        clip_adam_plain(state.params, grads, state.mu, state.nu, hp)
        return
    n = len(state.params)
    if not 0 < n <= _OPT_MAX_LEAVES or len(grads) != n:
        raise ValueError(f"clip_adam takes 1 to {_OPT_MAX_LEAVES} leaves "
                         f"and one gradient per leaf, got {n} and "
                         f"{len(grads)}")
    if (hp.rule == "rmsprop") != (state.mu is None):
        raise ValueError(f"rule {hp.rule!r} and the state's moments "
                         f"disagree")
    rebuilt = state.opt_table
    opt = _optimizer_table(state, kernels.forced("clip_adam"))
    parts = [("grads", grads)]
    if opt is not rebuilt:  # the state's leaves: checked when tabled
        parts += [("params", state.params), ("nu", state.nu)]
        if state.mu is not None:
            parts.append(("mu", state.mu))
    device = state.params[0].device
    for name, leaves in parts:
        for i, (t, p) in enumerate(zip(leaves, state.params)):
            if (not isinstance(t, torch.Tensor) or t.device != device
                    or t.dtype != torch.float32 or t.shape != p.shape
                    or not t.is_contiguous()):
                state.opt_table = None  # never table a leaf that failed
                kernels.check_cuda(f"{name}[{i}]", t, torch.float32,
                                   tuple(p.shape))
                raise ValueError(f"{name}[{i}] must lie on {device}")
    grad_table = (ctypes.c_int64 * n)(*(g.data_ptr() for g in grads))
    plan = opt.plan
    f32 = np.float32
    kernels.launch(
        "clip_adam", ctypes.addressof(grad_table), ctypes.addressof(
            opt.table), n, plan.chunks, plan.ctas,
        int(hp.grad_clip is not None), _OPT_RULES[hp.rule],
        float(hp.grad_clip or 0.0), hp.lr, hp.b1, float(f32(1.0 - hp.b1)),
        hp.b2, float(f32(1.0 - hp.b2)), hp.eps, hp.bc1, hp.bc2)


# -------------------------------------------------------------- the learner
class Learner:
    """The shared part of the port's learners over ``model`` (a
    ``GNNPolicy``) on one device. ``device`` is ``"cuda"`` unless the
    caller asks for ``"cpu"``; raises when CUDA is asked for and absent.
    The learner's float type is the model's (float32 on the card; the CPU
    parity runs use float64). ``cfg`` has ``lr`` and ``grad_clip`` (None:
    no clip), and, where it names ``opt_type: rmsprop``, rmsprop's
    ``decay``, ``momentum`` and ``epsilon``; any other ``opt_type`` is
    adam, as in the reference."""

    def __init__(self, model: GNNPolicy, cfg: Any, device: str = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.rmsprop = getattr(cfg, "opt_type", "adam") == "rmsprop"
        self.dtype = next(model.parameters()).dtype
        self.names = sorted(n for n, _ in model.named_parameters())
        self._arange: Dict[int, torch.Tensor] = {}

    # ------------------------------------------------------------- state
    def init_state(self, params: Optional[Mapping[str, Any]] = None
                   ) -> TrainState:
        """Copy ``params`` (a state dict; default: the model's current
        parameters) into the model and start the optimiser afresh."""
        live = dict(self.model.named_parameters())
        with torch.no_grad():
            if params is not None:
                missing = sorted(set(self.names) - set(params))
                if missing:
                    raise ValueError(f"params lack {missing}")
                for name in self.names:
                    live[name].copy_(torch.as_tensor(params[name]))
        plist = [live[n] for n in self.names]
        has_mu = not self.rmsprop or bool(self.cfg.momentum)
        return TrainState(
            names=list(self.names), params=plist,
            mu=[torch.zeros_like(p) for p in plist] if has_mu else None,
            nu=[torch.zeros_like(p) for p in plist])

    # ------------------------------------------------------------- acting
    def host_batch(self, obs: Mapping[str, Any], grad: bool = False
                   ) -> Dict[str, np.ndarray]:
        """A stacked host observation batch (the ``envs/obs.py`` keys, [B,
        ...] at the env's pad) as the forward's flattened-graph host arrays
        in the learner's float type, trimmed to the smallest bucket of the
        serving ladder that holds it (as ``stage_traj`` trims); with
        ``grad``, also the arrays the card's backward reads
        (``GRAD_INPUT_KEYS``)."""
        obs = {k: np.asarray(obs[k]) for k in TRAJ_OBS_KEYS}
        n_b, e_b = trim_bucket(obs["node_split"], obs["edge_split"],
                               obs["node_features"].shape[1],
                               obs["edge_features"].shape[1])
        obs["node_features"] = obs["node_features"][:, :n_b]
        for key in ("edge_features", "edges_src", "edges_dst"):
            obs[key] = obs[key][:, :e_b]
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))
        host = prepare_flat_batch(obs)
        return {k: (v.astype(fdt) if v.dtype.kind == "f" else v)
                for k, v in host.items()
                if grad or k not in GRAD_INPUT_KEYS}

    def device_batch(self, obs: Mapping[str, Any]
                     ) -> Dict[str, torch.Tensor]:
        """``host_batch`` (no backward) on the learner's device, in one
        host-to-device copy."""
        return pack_to_device(self.host_batch(obs), self.device)

    def sample_actions(self, obs: Mapping[str, Any], u: torch.Tensor,
                       model: Optional[GNNPolicy] = None, fetch: bool = True
                       ) -> Tuple[Any, Any, Any]:
        """Batched action sampling (``_sample_actions`` of the reference):
        the forward (K1-K3, K17) and K9 with the uniforms ``u`` [B, A] on
        the learner's device -> host (actions [B] int32, logp [B], values
        [B]) in one read-back; with ``fetch`` False the three stay on the
        device. ``model`` defaults to the learner's."""
        model = self.model if model is None else model
        with torch.no_grad():
            actions, logp, values = model.sample_batched(
                self.device_batch(obs), u)
            if not fetch:
                return actions, logp, values
            packed = torch.stack([actions.to(logp.dtype), logp,
                                  values]).cpu().numpy()
        return packed[0].astype(np.int32), packed[1], packed[2]

    def values(self, obs: Mapping[str, Any],
               model: Optional[GNNPolicy] = None, fetch: bool = True):
        """The value head alone on a stacked batch (the rollout's bootstrap
        values: no action is sampled, so K9 is not launched), on the host
        (or, with ``fetch`` False, on the device)."""
        model = self.model if model is None else model
        with torch.no_grad():
            _, values = model.trunk(self.device_batch(obs))
            return values.cpu().numpy() if fetch else values

    def greedy_actions(self, obs: Mapping[str, Any]) -> np.ndarray:
        """Greedy actions of a stacked batch: the forward and K4."""
        with torch.no_grad():
            _, _, actions = self.model.flat_batched(self.device_batch(obs))
            return actions.cpu().numpy()

    # ------------------------------------------------------------ staging
    def stage_traj(self, traj: Mapping[str, Any], last_values: Any
                   ) -> StagedTraj:
        """Stage a host trajectory (``obs`` dict of [T, B, ...] arrays at
        the env's pad, ``actions``, ``logp``, ``values``, ``rewards``,
        ``dones`` [T, B]; ``last_values`` [B]) on the device with one
        host-to-device copy. The observations are trimmed to the smallest
        bucket of the serving ladder that holds every sample (see
        ``trim_bucket``), and every sample's flattened graph and both CSRs
        are built here, once."""
        t_len, lanes = np.shape(traj["rewards"])
        # the reference's to_rows: [T, B, ...] -> [B, T, ...] -> [B*T, ...]
        rows = {k: np.swapaxes(np.asarray(traj["obs"][k]), 0, 1).reshape(
            (t_len * lanes,) + np.shape(traj["obs"][k])[2:])
            for k in TRAJ_OBS_KEYS}
        arrays, n_b, e_b = self.row_arrays(rows)
        n_actions = rows["action_mask"].shape[1]
        actions = np.swapaxes(np.asarray(traj["actions"]), 0, 1).reshape(-1)
        if actions.size and (actions.min() < 0
                             or actions.max() >= n_actions):
            raise ValueError(f"actions must lie in [0, {n_actions})")
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))

        def to_rows(x):
            return np.swapaxes(np.asarray(x), 0, 1).reshape(-1)

        arrays.update({
            "actions": actions.astype(np.int32),
            "old_logp": to_rows(traj["logp"]).astype(fdt),
            "old_values": to_rows(traj["values"]).astype(fdt),
            "rewards": np.asarray(traj["rewards"], fdt),
            "values": np.asarray(traj["values"], fdt),
            "dones": np.asarray(traj["dones"]).astype(fdt),
            "last_values": np.asarray(last_values, fdt),
        })
        return StagedTraj(pack_to_device(arrays, self.device), t_len, lanes,
                          n_b, e_b)

    def row_arrays(self, rows: Mapping[str, np.ndarray]
                   ) -> Tuple[Dict[str, np.ndarray], int, int]:
        """Host rows (the ``envs/obs.py`` keys, [S, ...] at the env's pad)
        as the staged per-sample arrays ``minibatch_gather`` reads
        (features in the learner's float type, ``action_mask``, each
        sample's ``structure`` and ``node_mask``), trimmed to the smallest
        bucket of the serving ladder that holds every sample (see
        ``trim_bucket``); returns them with the bucket (N, E)."""
        rows = {k: np.asarray(rows[k]) for k in TRAJ_OBS_KEYS}
        n_b, e_b = trim_bucket(rows["node_split"], rows["edge_split"],
                               rows["node_features"].shape[1],
                               rows["edge_features"].shape[1])
        rows["node_features"] = rows["node_features"][:, :n_b]
        for key in ("edge_features", "edges_src", "edges_dst"):
            rows[key] = rows[key][:, :e_b]
        # (prepare_flat_batch validates every real edge)
        structure, node_mask = sample_structure(rows)
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))
        return {
            "node_features": rows["node_features"].astype(fdt),
            "edge_features": rows["edge_features"].astype(fdt),
            "graph_features": rows["graph_features"].astype(fdt),
            "action_mask": rows["action_mask"].astype(np.int32),
            "structure": structure, "node_mask": node_mask.astype(fdt),
        }, n_b, e_b

    def _positions(self, n: int) -> torch.Tensor:
        out = self._arange.get(n)
        if out is None:
            out = self._arange[n] = torch.arange(n, dtype=torch.int64,
                                                 device=self.device)
        return out

    def minibatch(self, staged: StagedTraj, idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The flattened-graph batch of the samples ``idx`` [M] (int64 on
        the device), assembled on the device by K20 (``minibatch_gather``):
        equal, array for array, to ``prepare_flat_batch`` of the same
        samples."""
        return minibatch_gather(staged.tensors, idx, staged.n_nodes,
                                staged.n_edges)

    def full_batch(self, staged: StagedTraj) -> Dict[str, torch.Tensor]:
        """Every sample of the trajectory, in B-major row order: the batch
        of the single full-batch update of IMPALA and PG."""
        return self.minibatch(staged,
                              self._positions(staged.t_len * staged.lanes))

    # ---------------------------------------------------------- optimiser
    def _apply_optimizer(self, state: TrainState,
                         grads: List[torch.Tensor]) -> None:
        """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` (or
        ``rmsprop``) then ``apply_updates``, as the optimiser step
        ``state.step + 1`` (the caller counts the step), in place: K19
        (``clip_adam``) on the card, ``clip_adam_plain`` on the CPU."""
        cfg = self.cfg
        count = state.step + 1
        if self.rmsprop:
            hyper = OptimizerStep(
                rule="rmsprop_momentum" if state.mu is not None
                else "rmsprop", lr=cfg.lr, grad_clip=cfg.grad_clip,
                b1=cfg.momentum, b2=cfg.decay, eps=cfg.epsilon)
        else:
            hyper = OptimizerStep(
                rule="adam", lr=cfg.lr, grad_clip=cfg.grad_clip,
                b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS,
                bc1=self._bias_correction(ADAM_B1, count),
                bc2=self._bias_correction(ADAM_B2, count))
        clip_adam(state, grads, hyper)

    def _bias_correction(self, decay: float, count: int) -> float:
        """optax's ``1 - decay**count``, in the parameters' float type as
        optax takes it (a float32 power of float32 ``decay`` on the card:
        in float64 ``1 - 0.999`` is 1.3e-5 larger, enough to move a tiny
        adam step by 6e-6 of itself)."""
        if self.dtype == torch.float32:
            return float(np.float32(1.0)
                         - np.float32(decay) ** np.float32(count))
        return 1.0 - decay ** count

    def _loss_grads(self, total: torch.Tensor, state: TrainState
                    ) -> List[torch.Tensor]:
        """d total / d params; a parameter the loss does not reach (PG's
        value head) gets a zero gradient, as ``jax.grad`` gives it."""
        return list(torch.autograd.grad(total, state.params,
                                        allow_unused=True,
                                        materialize_grads=True))
