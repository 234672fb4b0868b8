from cavp_tpu_torch.ops.kernels.fusion import (
    fused_visual_fusion,
    fused_visual_fusion_reference,
)
from cavp_tpu_torch.ops.kernels.layer1 import (
    fused_layer1,
    fused_layer1_reference,
)
from cavp_tpu_torch.ops.kernels.mel import fused_log_mel, fused_log_mel_reference
from cavp_tpu_torch.ops.kernels.upsample_argmax import (
    upsample_argmax,
    upsample_argmax_reference,
)

__all__ = [
    "fused_layer1", "fused_layer1_reference", "fused_log_mel",
    "fused_log_mel_reference", "fused_visual_fusion",
    "fused_visual_fusion_reference", "upsample_argmax",
    "upsample_argmax_reference",
]
