"""PyTorch + CUDA port of ``ddls_tpu`` for NVIDIA Hopper (sm_90a).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``envs/``, ``rl/``, ``serve/``, ``telemetry/``)
and imports nothing of it. The device routines that XLA compiled for the
TPU become hand-written CUDA kernels (``kernels/``), each beside a plain
PyTorch version that runs wherever the tensors lie on the CPU.

What is ported so far: the serving path of the shipped PPO policy
(``python -m ddls_tpu_torch.serve``), the host simulator, every learner
of the JAX package, and its training loop, sequential or pipelined over
subprocess envs (``python -m ddls_tpu_torch.train``), forward and
backward through the kernels.
"""
