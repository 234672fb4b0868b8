from cavp_tpu_torch.losses.ce import cross_entropy
from cavp_tpu_torch.losses.contrast_extra import (
    av_contrast_loss,
    pixel_contrast_loss,
    supcon_loss,
)
from cavp_tpu_torch.losses.corocl import corocl_loss
from cavp_tpu_torch.losses.ohem import ohem_cross_entropy

__all__ = ["cross_entropy", "corocl_loss", "supcon_loss", "av_contrast_loss",
           "pixel_contrast_loss", "ohem_cross_entropy"]
