"""Host-side helpers: the PNG codec, option and image utilities, the HTML
gallery, the training visualizer and the Jacobian colormap."""

from dfmir_tpu_torch.utils.html import HTML
from dfmir_tpu_torch.utils.jac_vis import (diverging_rgb, jac_det_to_rgb,
                                           midpoint_normalize, overlay)
from dfmir_tpu_torch.utils.png import read_png, write_png
from dfmir_tpu_torch.utils.util import (copyconf, mkdirs, save_image,
                                        str2bool, tensor2im)
from dfmir_tpu_torch.utils.visualizer import Visualizer, save_images

__all__ = ["HTML", "diverging_rgb", "jac_det_to_rgb", "midpoint_normalize",
           "overlay", "read_png", "write_png", "copyconf", "mkdirs",
           "save_image", "str2bool", "tensor2im", "Visualizer",
           "save_images"]
