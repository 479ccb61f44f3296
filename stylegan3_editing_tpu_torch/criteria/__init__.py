"""Loss networks of the port (NHWC images)."""

from .clip_loss import CLIPLoss
from .id_loss import IDLoss
from .lpips import LPIPS, convert_lpips_linear_state
from .moco_loss import MocoLoss
from .ms_ssim import msssim, ssim
from .w_norm import w_norm_loss

__all__ = ["CLIPLoss", "IDLoss", "LPIPS", "convert_lpips_linear_state", "MocoLoss",
           "msssim", "ssim", "w_norm_loss"]
