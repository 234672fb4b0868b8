from cavp_tpu_torch.utils.wandb_logger import Tensorboard, log_to_console, logger

__all__ = ["Tensorboard", "log_to_console", "logger"]
