from stoch_gpmp_tpu_torch.utils.checkpoint import load_planner_state, save_planner_state
from stoch_gpmp_tpu_torch.utils.paths import get_assets_path, get_root_path
from stoch_gpmp_tpu_torch.utils.timer import Timer, elapsed_time, print_info

__all__ = [
    "get_assets_path",
    "get_root_path",
    "Timer",
    "elapsed_time",
    "print_info",
    "load_planner_state",
    "save_planner_state",
]
