"""Agent checkpointing in torch.

Counterpart of ``ddls_tpu/train/checkpointer.py``: ``Checkpointer`` owns
the directory layout (the cadence belongs to the JAX package's launcher,
which is not ported), and ``save_train_state`` /
``restore_train_state`` write and read a learner's ``TrainState`` (the
params by name, the optimiser's moments: adam's ``mu`` and ``nu``, or
rmsprop's ``nu`` and, with momentum, its trace in ``mu``; PPO's
``kl_coeff``; DQN's target network's ``target_params``; ``step``) with
``torch.save`` into ``<path>/train_state.pt``, where the JAX package
writes an orbax tree. A restore copies into a target state in place, so a
saved and restored state is bit-equal and stays on the target's device.
The shipped weights come in through the numpy export instead
(``serve.server.load_export``).
"""
from __future__ import annotations

from pathlib import Path
import torch

STATE_FILE = "train_state.pt"


class Checkpointer:
    """The checkpoint directory layout: ``<path_to_save>/checkpoints/
    checkpoint_<epoch>``."""

    def __init__(self, path_to_save: str):
        self.checkpoints_dir = Path(path_to_save) / "checkpoints"
        self.checkpoints_dir.mkdir(parents=True, exist_ok=True)

    def write(self, epoch_loop, epoch_counter: int) -> str:
        path = self.checkpoints_dir / f"checkpoint_{epoch_counter:06d}"
        epoch_loop.save_agent_checkpoint(str(path))
        return str(path)


def save_train_state(state, path: str) -> None:
    """Write ``state`` (a ``rl.learner.TrainState``) under the directory
    ``path`` as host tensors; a part the learner does not keep (``mu`` of
    rmsprop without momentum, ``kl_coeff`` outside PPO, ``target_params``
    outside DQN) is not written."""
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    saved = {"names": list(state.names),
             "params": [p.detach().cpu() for p in state.params],
             "nu": [n.cpu() for n in state.nu],
             "step": int(state.step)}
    if state.mu is not None:
        saved["mu"] = [m.cpu() for m in state.mu]
    if state.kl_coeff is not None:
        saved["kl_coeff"] = state.kl_coeff.detach().cpu()
    if state.target_params is not None:
        saved["target_params"] = [p.detach().cpu()
                                  for p in state.target_params]
    torch.save(saved, out / STATE_FILE)


def restore_train_state(path: str, target):
    """Copy the state saved under ``path`` into ``target`` (a
    ``TrainState`` of the same learner: parameter names, shapes and
    optimiser parts) in place and return it; raises on a mismatch."""
    saved = torch.load(Path(path) / STATE_FILE, map_location="cpu",
                       weights_only=True)
    if list(saved["names"]) != list(target.names):
        raise ValueError(f"{path}: checkpoint params {saved['names']} do "
                         f"not match the target's {target.names}")
    for key in ("mu", "kl_coeff", "target_params"):
        if (key in saved) != (getattr(target, key) is not None):
            raise ValueError(f"{path}: {key} is in one of the checkpoint "
                             f"and the target and not in the other (another "
                             f"learner or optimiser)")
    with torch.no_grad():
        for key in ("params", "mu", "nu", "target_params"):
            for dst, src in zip(getattr(target, key) or (),
                                saved.get(key, ())):
                if dst.shape != src.shape:
                    raise ValueError(f"{path}: {key} shape {tuple(src.shape)}"
                                     f" != target {tuple(dst.shape)}")
                dst.copy_(src)
        if "kl_coeff" in saved:
            target.kl_coeff = saved["kl_coeff"].to(target.kl_coeff.device)
    target.step = int(saved["step"])
    return target
