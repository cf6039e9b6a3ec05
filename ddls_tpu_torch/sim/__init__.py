"""The RAMP cluster simulator, host only (copy of ``ddls_tpu/sim``
without its JAX engines and the legacy cluster)."""
from ddls_tpu_torch.sim.actions import (Action, DepPlacement, DepSchedule,
                                        OpPartition, OpPlacement, OpSchedule)
from ddls_tpu_torch.sim.cluster import RampClusterEnvironment
from ddls_tpu_torch.sim.comm_model import (one_to_one_time,
                                           ramp_all_reduce_time)
from ddls_tpu_torch.sim.partition import partition_graph, partitioned_op_id

__all__ = [
    "one_to_one_time", "ramp_all_reduce_time", "RampClusterEnvironment",
    "Action", "OpPartition", "OpPlacement", "OpSchedule", "DepPlacement",
    "DepSchedule", "partition_graph", "partitioned_op_id",
]
