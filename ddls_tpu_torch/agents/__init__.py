"""The heuristic control plane of the partitioning env (copy of
``ddls_tpu/agents`` without the legacy job managers)."""
from ddls_tpu_torch.agents.partitioners import (RandomOpPartitioner,
                                                SipMlOpPartitioner,
                                                sip_ml_num_partitions)
from ddls_tpu_torch.agents.placers import (FirstFitDepPlacer,
                                           RampFirstFitOpPlacer,
                                           RandomOpPlacer)
from ddls_tpu_torch.agents.schedulers import (SRPTDepScheduler,
                                              SRPTOpScheduler)

__all__ = [
    "SipMlOpPartitioner", "RandomOpPartitioner", "sip_ml_num_partitions",
    "RampFirstFitOpPlacer", "RandomOpPlacer", "FirstFitDepPlacer",
    "SRPTOpScheduler", "SRPTDepScheduler",
]
