from stoch_gpmp_tpu_torch.gp.lift import phi_matrix, q_inv_block, qc_inv_matrix, unary_weight
from stoch_gpmp_tpu_torch.gp.tridiag import BlockBidiagChol, BlockTridiag
from stoch_gpmp_tpu_torch.gp.prior import (
    GPPrior,
    build_precision,
    const_vel_means,
    const_vel_trajectory,
    make_gp_prior,
)

__all__ = [
    "phi_matrix",
    "q_inv_block",
    "qc_inv_matrix",
    "unary_weight",
    "BlockTridiag",
    "BlockBidiagChol",
    "GPPrior",
    "build_precision",
    "const_vel_means",
    "const_vel_trajectory",
    "make_gp_prior",
]
