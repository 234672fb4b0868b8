from cavp_tpu_torch.models.cavp import CAVP

__all__ = ["CAVP"]
