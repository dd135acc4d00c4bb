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
    "IterMetrics",
    "SamplerModel",
    "StochGPMP",
    "StochGPMPAux",
    "StochGPMPState",
    "stoch_gpmp_optimize",
    "stoch_gpmp_step",
]
