from cavp_tpu_torch.models.cavp import CAVP, VisualModel

__all__ = ["CAVP", "VisualModel"]
