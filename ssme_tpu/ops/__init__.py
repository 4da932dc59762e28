# ``filter_megakernel`` the function is not re-exported: it would shadow
# the submodule of the same name.
from ssme_tpu.ops.filter_megakernel import (
    KernelModel,
    MAX_KERNEL_PARTICLES,
    factor_svol_kernel_model,
    megakernel_log_like,
    megakernel_swarm_evidence,
    poisson_ar_kernel_model,
    poisson_obs_rows,
    svol_kernel_model,
    svol_leverage_kernel_model,
    svol_param_rows,
    svol_t_kernel_model,
    svol_t_param_rows,
)

__all__ = [
    "KernelModel",
    "MAX_KERNEL_PARTICLES",
    "factor_svol_kernel_model",
    "megakernel_log_like",
    "megakernel_swarm_evidence",
    "poisson_ar_kernel_model",
    "poisson_obs_rows",
    "svol_kernel_model",
    "svol_leverage_kernel_model",
    "svol_param_rows",
    "svol_t_kernel_model",
    "svol_t_param_rows",
]
