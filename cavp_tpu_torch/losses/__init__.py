from cavp_tpu_torch.losses.ce import cross_entropy
from cavp_tpu_torch.losses.corocl import corocl_loss

__all__ = ["cross_entropy", "corocl_loss"]
