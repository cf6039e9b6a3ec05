"""Graph primitives of the port: masked segment reductions (plain PyTorch)
and the dispatching wrappers of the CSR segment-mean and pooling kernels
and of their backwards."""
from ddls_tpu_torch.ops.segment import (build_csr, csr_segment_mean,
                                        csr_segment_mean_bwd,
                                        csr_segment_sum, masked_mean,
                                        masked_mean_pool_concat,
                                        masked_mean_pool_concat_bwd,
                                        masked_segment_mean,
                                        masked_segment_sum)

__all__ = ["masked_segment_sum", "masked_segment_mean", "masked_mean",
           "build_csr", "csr_segment_mean", "masked_mean_pool_concat",
           "csr_segment_mean_bwd", "csr_segment_sum",
           "masked_mean_pool_concat_bwd"]
