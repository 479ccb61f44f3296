"""Loss networks of the port (NHWC images)."""

from .clip_loss import CLIPLoss
from .id_loss import IDLoss
from .lpips import LPIPS, convert_lpips_linear_state

__all__ = ["CLIPLoss", "IDLoss", "LPIPS", "convert_lpips_linear_state"]
