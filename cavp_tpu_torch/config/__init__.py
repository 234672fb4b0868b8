from cavp_tpu_torch.config.setups import Config, get_config

__all__ = ["Config", "get_config"]
