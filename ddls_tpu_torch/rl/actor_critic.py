"""The actor-critic loss that the IMPALA and policy-gradient learners
share (K12), with its plain PyTorch version.

Counterpart of ``ddls_tpu/rl/impala.py:201`` ``ImpalaLearner._loss`` and
``ddls_tpu/rl/pg.py:141`` ``PGLearner._loss`` after their forward and
their scan: one log-softmax over the masked logits, the action's
log-probability, ``-mean(logp * w)``, the value MSE against ``vs``, the
entropy with the reference's ``isfinite`` guard, and the importance-weight
metrics, over the kept rows. Rows are the staged trajectory's B-major rows
(row = b * T + t); ``drop_last`` drops each lane's last step t = T - 1,
as IMPALA's ``vtrace_drop_last_ts`` drops the reference's ``[:-1]``. PG is
the same loss with ``w`` the reward-to-go, ``vf_coeff = ent_coeff = 0``
and no dropped step.

On the card ``ac_loss`` is K12 (``kernels/csrc/ac_loss.cu``): the loss,
its metrics and its gradient with respect to the logits and the values in
one launch, inside a ``torch.autograd.Function``; ``ac_logp`` is the same
source's row log-probability, which V-trace needs before the loss runs.
For tensors on the CPU both take their plain versions.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels

# K12's metrics, in order; IMPALA reports the first six, PG policy_loss,
# total_loss and the mean weight as mean_return_to_go
AC_METRIC_KEYS = ("policy_loss", "vf_loss", "entropy", "total_loss",
                  "mean_rho", "clip_rho_fraction", "mean_weight")


def _check_rows(logits: torch.Tensor, actions: torch.Tensor) -> None:
    kernels.check_cuda("logits", logits, torch.float32)
    if logits.dim() != 2 or not 0 < logits.shape[1] <= 64:
        raise ValueError(f"logits must be [R, A] with 0 < A <= 64, got "
                         f"{tuple(logits.shape)}")
    kernels.check_cuda("actions", actions, torch.int32,
                       (logits.shape[0],))


# ------------------------------------------------------ the action's logp
def ac_logp_plain(logits: torch.Tensor, actions: torch.Tensor
                  ) -> torch.Tensor:
    """log_softmax(logits)[row, action] per row."""
    return torch.gather(torch.log_softmax(logits, dim=-1), 1,
                        actions.long()[:, None])[:, 0]


def ac_logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """K12's ``ac_logp``: the log-probability [R] of each row's action
    under the masked logits [R, A] (float32, no gradient); ``actions``
    [R] int32."""
    if kernels.on_cpu(logits, actions):
        return ac_logp_plain(logits, actions)
    _check_rows(logits, actions)
    out = logits.new_empty(logits.shape[0])
    if logits.shape[0]:
        kernels.launch("ac_logp", logits.data_ptr(), actions.data_ptr(),
                       out.data_ptr(), logits.shape[0], logits.shape[1])
    return out


# --------------------------------------------------------------- the loss
def keep_rows(rows: int, t_len: int, drop_last: bool,
              device: torch.device) -> torch.Tensor:
    """Bool [rows]: every row, or every row but each lane's step T - 1."""
    keep = torch.ones(rows, dtype=torch.bool, device=device)
    if drop_last:
        keep[t_len - 1::t_len] = False
    return keep


def ac_loss_plain(logits, values, actions, weights, vs, behavior_logp,
                  t_len: int, drop_last: bool, vf_coeff: float,
                  ent_coeff: float, clip_rho: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The loss over the kept rows (``ddls_tpu/rl/impala.py:_loss``'s
    arithmetic after the forward and V-trace): returns ``(total,
    metrics)``, ``metrics`` the [7] tensor in ``AC_METRIC_KEYS`` order.
    ``clip_rho_fraction`` is a float32 mean, as the reference's."""
    keep = keep_rows(logits.shape[0], t_len, drop_last, logits.device)
    logp_all = torch.log_softmax(logits, dim=-1)[keep]
    lp = torch.gather(logp_all, 1, actions.long()[keep][:, None])[:, 0]
    w = weights[keep]
    policy_loss = -torch.mean(lp * w)
    vf_loss = 0.5 * torch.mean((values[keep] - vs[keep]) ** 2)
    logp_masked = torch.where(torch.isfinite(logp_all), logp_all,
                              torch.zeros((), dtype=logp_all.dtype))
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_masked,
                                    dim=-1))
    total = policy_loss + vf_coeff * vf_loss - ent_coeff * entropy
    rho = torch.exp(lp - behavior_logp[keep])
    # a float32 mean, as the reference's, taken as XLA takes it: the count
    # times the float32 reciprocal of N (a count over N would round
    # otherwise for some N)
    clip_frac = torch.sum((rho > clip_rho).to(torch.float32)) * torch.tensor(
        np.float32(1.0) / np.float32(rho.shape[0]))
    metrics = torch.stack([policy_loss, vf_loss, entropy, total,
                           torch.mean(rho), clip_frac.to(logits.dtype),
                           torch.mean(w)])
    return total, metrics


def ac_loss_grad_plain(logits, values, actions, weights, vs, behavior_logp,
                       t_len: int, drop_last: bool, vf_coeff: float,
                       ent_coeff: float, clip_rho: float):
    """K12's whole output from the plain version: ``(total, metrics,
    d total / d logits, d total / d values)``, the gradient by autograd."""
    logits = logits.detach().requires_grad_(True)
    values = values.detach().requires_grad_(True)
    with torch.enable_grad():
        total, metrics = ac_loss_plain(logits, values, actions, weights, vs,
                                       behavior_logp, t_len, drop_last,
                                       vf_coeff, ent_coeff, clip_rho)
        dlogits, dvalues = torch.autograd.grad(total, (logits, values),
                                               allow_unused=True,
                                               materialize_grads=True)
    return total.detach(), metrics.detach(), dlogits, dvalues


def _ac_loss_cuda(logits, values, actions, weights, vs, behavior_logp,
                  t_len: int, drop_last: bool, vf_coeff: float,
                  ent_coeff: float, clip_rho: float):
    """K12: (total [], metrics [7], dlogits [R, A], dvalues [R])."""
    _check_rows(logits, actions)
    rows, a = logits.shape
    for name, t in (("values", values), ("weights", weights), ("vs", vs),
                    ("behavior_logp", behavior_logp)):
        kernels.check_cuda(name, t, torch.float32, (rows,))
    if t_len <= 0 or rows % t_len:
        raise ValueError(f"{rows} rows are not whole lanes of {t_len} steps")
    rowterms = logits.new_empty((6, rows))
    metrics = logits.new_empty(len(AC_METRIC_KEYS))
    total = logits.new_empty(())
    dlogits = torch.empty_like(logits)
    dvalues = torch.empty_like(values)
    if rows:
        kernels.launch("ac_loss", logits.data_ptr(), values.data_ptr(),
                       actions.data_ptr(), weights.data_ptr(), vs.data_ptr(),
                       behavior_logp.data_ptr(), rowterms.data_ptr(),
                       metrics.data_ptr(), total.data_ptr(),
                       dlogits.data_ptr(), dvalues.data_ptr(), rows, a,
                       int(t_len), int(bool(drop_last)), float(vf_coeff),
                       float(ent_coeff), float(clip_rho))
    return total, metrics, dlogits, dvalues


class _ACLoss(torch.autograd.Function):
    """K12 computes the gradient in the forward launch; the backward scales
    the saved gradient by the incoming one."""

    @staticmethod
    def forward(ctx, logits, values, actions, weights, vs, behavior_logp,
                t_len, drop_last, vf_coeff, ent_coeff, clip_rho):
        total, metrics, dlogits, dvalues = _ac_loss_cuda(
            logits, values, actions, weights, vs, behavior_logp, t_len,
            drop_last, vf_coeff, ent_coeff, clip_rho)
        ctx.save_for_backward(dlogits, dvalues)
        ctx.mark_non_differentiable(metrics)
        return total, metrics

    @staticmethod
    def backward(ctx, d_total, d_metrics):
        dlogits, dvalues = ctx.saved_tensors
        return (dlogits * d_total, dvalues * d_total) + (None,) * 9


def ac_loss(logits: torch.Tensor, values: torch.Tensor,
            actions: torch.Tensor, weights: torch.Tensor, vs: torch.Tensor,
            behavior_logp: torch.Tensor, t_len: int, drop_last: bool,
            vf_coeff: float, ent_coeff: float, clip_rho: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K12: ``(total, metrics [7])`` of the IMPALA or PG loss over the
    B-major rows (``ac_loss_plain``), differentiable with respect to
    ``logits`` [R, A] (masked, float32) and ``values`` [R]; ``actions`` [R]
    int32, ``weights``, ``vs`` and ``behavior_logp`` [R], R a whole number
    of lanes of ``t_len`` steps."""
    if kernels.on_cpu(logits, values, actions, weights, vs, behavior_logp):
        return ac_loss_plain(logits, values, actions, weights, vs,
                             behavior_logp, t_len, drop_last, vf_coeff,
                             ent_coeff, clip_rho)
    return _ACLoss.apply(logits, values, actions, weights, vs, behavior_logp,
                         t_len, drop_last, vf_coeff, ent_coeff, clip_rho)
