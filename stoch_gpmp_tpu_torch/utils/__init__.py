from stoch_gpmp_tpu_torch.utils.timer import Timer, elapsed_time, print_info

__all__ = ["Timer", "elapsed_time", "print_info"]
