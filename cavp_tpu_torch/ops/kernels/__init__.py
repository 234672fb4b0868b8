from cavp_tpu_torch.ops.kernels.fusion import (
    fused_visual_fusion,
    fused_visual_fusion_reference,
)

__all__ = ["fused_visual_fusion", "fused_visual_fusion_reference"]
