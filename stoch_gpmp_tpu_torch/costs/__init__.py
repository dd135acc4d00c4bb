from stoch_gpmp_tpu_torch.costs.costs import (
    Cost,
    CostCollision,
    CostComposite,
    CostGP,
    CostGoal,
    CostGoalPrior,
    CostGPTrajectory,
    GNContrib,
)
from stoch_gpmp_tpu_torch.costs.fields import (
    EESE3DistanceField,
    LinkDistanceField,
    LinkSelfDistanceField,
    MeshSphereDistanceField,
    MeshSphereFloorField,
    OccupancyGridField,
    Primitive2DField,
    RasterPrimitive2DField,
)
from stoch_gpmp_tpu_torch.costs.fused_fields import FusedLinkFieldsCost, PlaneFieldsCost
from stoch_gpmp_tpu_torch.costs.quadratic import QuadraticCost

__all__ = [
    "Cost",
    "CostCollision",
    "CostComposite",
    "CostGP",
    "CostGoal",
    "CostGoalPrior",
    "CostGPTrajectory",
    "GNContrib",
    "EESE3DistanceField",
    "FusedLinkFieldsCost",
    "LinkDistanceField",
    "LinkSelfDistanceField",
    "MeshSphereDistanceField",
    "MeshSphereFloorField",
    "OccupancyGridField",
    "PlaneFieldsCost",
    "Primitive2DField",
    "RasterPrimitive2DField",
    "QuadraticCost",
]
