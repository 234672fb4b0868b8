from cavp_tpu_torch.config.flags import build_parser, load_args_and_config
from cavp_tpu_torch.config.setups import Config, get_config

__all__ = ["Config", "get_config", "build_parser", "load_args_and_config"]
