"""Generator models (terrain_tpu/models), NHWC in and out."""

from terrain_tpu_torch.models import dcgan, unet
from terrain_tpu_torch.models.core import param_count

__all__ = ["dcgan", "unet", "param_count"]
