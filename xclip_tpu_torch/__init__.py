"""xclip_tpu_torch: the PyTorch/CUDA port of xclip_tpu for one NVIDIA H100.

This slice serves CLIP inference. Plain tensor code is PyTorch; the two
Pallas kernels on the inference path are hand-written CUDA kernels for
Hopper (`csrc/`), built with nvcc at first use. The package never imports
JAX; `xclip_tpu` is the reference it is tested against.
"""

from .api import CLIP
from .model import CLIPModel
from .nn.text import TextTransformer
from .nn.vision import VisionTransformer

__all__ = ["CLIP", "CLIPModel", "TextTransformer", "VisionTransformer"]
