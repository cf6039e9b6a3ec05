"""Graph primitives of the port: masked segment reductions (plain PyTorch)
and the dispatching wrappers of the CSR segment-mean and pooling kernels."""
from ddls_tpu_torch.ops.segment import (build_csr, csr_segment_mean,
                                        masked_mean, masked_mean_pool_concat,
                                        masked_segment_mean,
                                        masked_segment_sum)

__all__ = ["masked_segment_sum", "masked_segment_mean", "masked_mean",
           "build_csr", "csr_segment_mean", "masked_mean_pool_concat"]
