from stoch_gpmp_tpu_torch.planners.gpmp import (
    GPMP,
    GPMPState,
    WoodburyGN,
    build_woodbury,
    gpmp_optimize,
    gpmp_step,
    gpmp_step_woodbury,
)
from stoch_gpmp_tpu_torch.planners.stoch_gpmp import (
    IterMetrics,
    SamplerModel,
    StochGPMP,
    StochGPMPAux,
    StochGPMPState,
    stoch_gpmp_optimize,
    stoch_gpmp_step,
)

__all__ = [
    "GPMP",
    "GPMPState",
    "WoodburyGN",
    "build_woodbury",
    "gpmp_optimize",
    "gpmp_step",
    "gpmp_step_woodbury",
    "IterMetrics",
    "SamplerModel",
    "StochGPMP",
    "StochGPMPAux",
    "StochGPMPState",
    "stoch_gpmp_optimize",
    "stoch_gpmp_step",
]
