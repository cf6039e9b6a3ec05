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
  host; ``minibatch`` gathers samples and offsets and concatenates their
  CSRs with a few tensor ops, with no host round trip;
* the optimiser: optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))``
  (adam alone where ``grad_clip`` is None, as ES's) or, for
  IMPALA's ``opt_type: rmsprop``, ``chain(clip_by_global_norm,
  rmsprop(lr, decay, eps, momentum))``, in optax's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch.models.policy import (GRAD_INPUT_KEYS, GNNPolicy,
                                          prepare_flat_batch)
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


def _sample_structure(obs: Dict[str, np.ndarray]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Per sample, the int32 row ``[src E | edge_dst E | dst row_ptr N+1 |
    dst col E | src row_ptr N+1 | src col E]`` of its own flattened graph
    (a batch of one) and its float node mask [N]: what the device offsets
    and concatenates into a minibatch."""
    n = obs["node_features"].shape[0]
    rows, masks = [], []
    for i in range(n):
        one = {k: obs[k][i:i + 1] for k in TRAJ_OBS_KEYS}
        host = prepare_flat_batch(one)
        rows.append(np.concatenate([
            host["src"], host["edge_dst"], host["csr_row_ptr"],
            host["csr_col"], host["src_csr_row_ptr"], host["src_csr_col"]]))
        masks.append(host["node_mask"])
    return np.stack(rows).astype(np.int32), np.stack(masks)


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

    def sample_actions(self, obs: Mapping[str, Any], u: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched action sampling (``_sample_actions`` of the reference):
        the forward and K9 with the uniforms ``u`` [B, A] on the learner's
        device -> host (actions [B] int32, logp [B], values [B]) in one
        read-back."""
        with torch.no_grad():
            actions, logp, values = self.model.sample_batched(
                self.device_batch(obs), u)
            packed = torch.stack([actions.to(logp.dtype), logp,
                                  values]).cpu().numpy()
        return packed[0].astype(np.int32), packed[1], packed[2]

    def values(self, obs: Mapping[str, Any]) -> np.ndarray:
        """The value head alone on a stacked batch (the rollout's bootstrap
        values: no action is sampled, so K9 is not launched)."""
        with torch.no_grad():
            _, values = self.model.trunk(self.device_batch(obs))
            return values.cpu().numpy()

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
        obs = {k: np.asarray(traj["obs"][k]) for k in TRAJ_OBS_KEYS}
        t_len, lanes = np.shape(traj["rewards"])
        n_pad, e_pad = obs["node_features"].shape[2], obs[
            "edge_features"].shape[2]
        n_b, e_b = trim_bucket(obs["node_split"], obs["edge_split"], n_pad,
                               e_pad)
        obs["node_features"] = obs["node_features"][:, :, :n_b]
        for key in ("edge_features", "edges_src", "edges_dst"):
            obs[key] = obs[key][:, :, :e_b]
        # the reference's to_rows: [T, B, ...] -> [B, T, ...] -> [B*T, ...]
        rows = {k: np.swapaxes(v, 0, 1).reshape((t_len * lanes,)
                                                + v.shape[2:])
                for k, v in obs.items()}
        n_actions = rows["action_mask"].shape[1]
        actions = np.swapaxes(np.asarray(traj["actions"]), 0, 1).reshape(-1)
        if actions.size and (actions.min() < 0
                             or actions.max() >= n_actions):
            raise ValueError(f"actions must lie in [0, {n_actions})")
        # (prepare_flat_batch, per sample, validates every real edge)
        structure, node_mask = _sample_structure(rows)
        fdt = np.dtype(str(self.dtype).replace("torch.", ""))

        def to_rows(x):
            return np.swapaxes(np.asarray(x), 0, 1).reshape(-1)

        arrays = {
            "node_features": rows["node_features"].astype(fdt),
            "edge_features": rows["edge_features"].astype(fdt),
            "graph_features": rows["graph_features"].astype(fdt),
            "action_mask": rows["action_mask"].astype(np.int32),
            "structure": structure, "node_mask": node_mask.astype(fdt),
            "actions": actions.astype(np.int32),
            "old_logp": to_rows(traj["logp"]).astype(fdt),
            "old_values": to_rows(traj["values"]).astype(fdt),
            "rewards": np.asarray(traj["rewards"], fdt),
            "values": np.asarray(traj["values"], fdt),
            "dones": np.asarray(traj["dones"]).astype(fdt),
            "last_values": np.asarray(last_values, fdt),
        }
        return StagedTraj(pack_to_device(arrays, self.device), t_len, lanes,
                          n_b, e_b)

    def _positions(self, n: int) -> torch.Tensor:
        out = self._arange.get(n)
        if out is None:
            out = self._arange[n] = torch.arange(n, dtype=torch.int32,
                                                 device=self.device)
        return out

    def _offset_csr(self, row_ptr, col, m: int, n_nodes: int,
                    n_edges: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Concatenate m per-sample CSRs ([m, N+1] local row_ptr, [m, E]
        local col) into the flattened graph's: row_ptr shifted by the
        running edge count, col by each sample's edge offset and packed
        after the previous sample's real edges (``build_csr``'s layout;
        entries past the last real edge are 0)."""
        nnz = row_ptr[:, n_nodes]
        start = torch.cumsum(nnz, 0, dtype=torch.int32) - nnz
        flat_ptr = torch.cat([(row_ptr[:, :n_nodes]
                               + start[:, None]).reshape(-1),
                              (start[-1:] + nnz[-1:])])
        pos_e = self._positions(n_edges)
        slot = torch.where(pos_e[None, :] < nnz[:, None],
                           start[:, None] + pos_e[None, :],
                           torch.full_like(start[:, None], m * n_edges))
        edge_off = (self._positions(m) * n_edges)[:, None]
        flat_col = torch.zeros(m * n_edges + 1, dtype=torch.int32,
                               device=self.device)
        flat_col.scatter_(0, slot.reshape(-1).long(),
                          (col + edge_off).reshape(-1))
        return flat_ptr, flat_col[:-1]

    def minibatch(self, staged: StagedTraj, idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """The flattened-graph batch of the samples ``idx`` [M] (int64 on
        the device), assembled on the device: equal, array for array, to
        ``prepare_flat_batch`` of the same samples."""
        n, e = staged.n_nodes, staged.n_edges
        m = idx.shape[0]
        s = staged["structure"].index_select(0, idx)
        p = 0
        parts = []
        for width in (e, e, n + 1, e, n + 1, e):
            parts.append(s[:, p:p + width])
            p += width
        src, edge_dst, dst_ptr, dst_col, src_ptr, src_col = parts
        node_off = (self._positions(m) * n)[:, None]
        row_ptr, col = self._offset_csr(dst_ptr, dst_col, m, n, e)
        s_row_ptr, s_col = self._offset_csr(src_ptr, src_col, m, n, e)
        return {
            "node_features": staged["node_features"].index_select(0, idx),
            "edge_features": staged["edge_features"].index_select(0, idx),
            "graph_features": staged["graph_features"].index_select(0, idx),
            "action_mask": staged["action_mask"].index_select(0, idx),
            "src": (src + node_off).reshape(-1),
            "node_mask": staged["node_mask"].index_select(0, idx).reshape(
                -1),
            "csr_row_ptr": row_ptr, "csr_col": col,
            "edge_dst": torch.where(edge_dst >= 0, edge_dst + node_off,
                                    edge_dst).reshape(-1),
            "src_csr_row_ptr": s_row_ptr, "src_csr_col": s_col,
        }

    def full_batch(self, staged: StagedTraj) -> Dict[str, torch.Tensor]:
        """Every sample of the trajectory, in B-major row order: the batch
        of the single full-batch update of IMPALA and PG."""
        n = staged.t_len * staged.lanes
        return self.minibatch(staged, self._positions(n).long())

    # ---------------------------------------------------------- optimiser
    def _apply_optimizer(self, state: TrainState,
                         grads: List[torch.Tensor]) -> None:
        """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` (or
        ``rmsprop``) then ``apply_updates``, in its arithmetic, as the
        optimiser step ``state.step + 1`` (the caller counts the step). The
        clip keeps ``g`` where the global norm is below ``grad_clip``, else
        takes ``g / norm * grad_clip`` (chosen on
        the device, no host round trip). adam: ``mu = (1 - b1) g + b1 mu``,
        ``nu = (1 - b2) g^2 + b2 nu``, ``update = mu_hat / (sqrt(nu_hat) +
        eps)`` with ``x_hat = x / (1 - b^count)``. rmsprop (``scale_by_rms``
        with eps inside the root, then ``-lr``, then ``trace``): ``nu = (1 -
        decay) g^2 + decay nu``, ``update = -lr g rsqrt(nu + eps)``, and
        with momentum ``trace = update + momentum trace``. Last, ``p +=
        update``."""
        cfg = self.cfg
        if cfg.grad_clip is not None:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            keep = norm < cfg.grad_clip
            one = torch.ones((), dtype=norm.dtype, device=norm.device)
            grads = torch._foreach_div(grads, torch.where(keep, one, norm))
            torch._foreach_mul_(grads, torch.where(
                keep, one, torch.full_like(one, cfg.grad_clip)))
        count = state.step + 1
        if self.rmsprop:
            updates = self._rmsprop(state, grads)
        else:
            scaled = torch._foreach_mul(grads, 1.0 - ADAM_B1)
            torch._foreach_mul_(state.mu, ADAM_B1)
            torch._foreach_add_(state.mu, scaled)
            squared = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(squared, 1.0 - ADAM_B2)
            torch._foreach_mul_(state.nu, ADAM_B2)
            torch._foreach_add_(state.nu, squared)
            mu_hat = torch._foreach_div(state.mu,
                                        self._bias_correction(ADAM_B1, count))
            denom = torch._foreach_div(state.nu,
                                       self._bias_correction(ADAM_B2, count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(updates, -cfg.lr)
        torch._foreach_add_(state.params, updates)

    def _bias_correction(self, decay: float, count: int) -> float:
        """optax's ``1 - decay**count``, in the parameters' float type as
        optax takes it (a float32 power of float32 ``decay`` on the card:
        in float64 ``1 - 0.999`` is 1.3e-5 larger, enough to move a tiny
        adam step by 6e-6 of itself)."""
        if self.dtype == torch.float32:
            return float(np.float32(1.0)
                         - np.float32(decay) ** np.float32(count))
        return 1.0 - decay ** count

    def _rmsprop(self, state: TrainState, grads: List[torch.Tensor]
                 ) -> List[torch.Tensor]:
        cfg = self.cfg
        squared = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squared, 1.0 - cfg.decay)
        torch._foreach_mul_(state.nu, cfg.decay)
        torch._foreach_add_(state.nu, squared)
        scale = torch._foreach_add(state.nu, cfg.epsilon)
        torch._foreach_rsqrt_(scale)
        updates = torch._foreach_mul(scale, grads)
        torch._foreach_mul_(updates, -cfg.lr)
        if state.mu is None:
            return updates
        torch._foreach_mul_(state.mu, cfg.momentum)
        torch._foreach_add_(state.mu, updates)
        return state.mu

    def _loss_grads(self, total: torch.Tensor, state: TrainState
                    ) -> List[torch.Tensor]:
        """d total / d params; a parameter the loss does not reach (PG's
        value head) gets a zero gradient, as ``jax.grad`` gives it."""
        return list(torch.autograd.grad(total, state.params,
                                        allow_unused=True,
                                        materialize_grads=True))
