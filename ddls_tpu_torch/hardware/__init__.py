"""Simulated devices and topologies (copy of ``ddls_tpu/hardware``)."""
from ddls_tpu_torch.hardware.devices import (A100, Channel, Processor, TPUv4,
                                             TPUv5e)
from ddls_tpu_torch.hardware.topologies import (RampTopology, TorusTopology,
                                                build_topology)

__all__ = ["A100", "TPUv4", "TPUv5e", "Channel", "Processor",
           "RampTopology", "TorusTopology", "build_topology"]
