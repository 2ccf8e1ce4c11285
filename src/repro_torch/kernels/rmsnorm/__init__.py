from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

__all__ = ["rmsnorm", "rmsnorm_bwd_ref", "rmsnorm_cuda", "rmsnorm_ref"]
