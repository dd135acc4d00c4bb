from stoch_gpmp_tpu_torch.costs.costs import (
    Cost,
    CostCollision,
    CostComposite,
    CostGP,
    CostGoalPrior,
)
from stoch_gpmp_tpu_torch.costs.fields import OccupancyGridField, RasterPrimitive2DField
from stoch_gpmp_tpu_torch.costs.fused_fields import PlaneFieldsCost
from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost

__all__ = [
    "Cost",
    "CostCollision",
    "CostComposite",
    "CostGP",
    "CostGoalPrior",
    "OccupancyGridField",
    "PlaneFieldsCost",
    "RasterPrimitive2DField",
    "QuadraticCost",
]
