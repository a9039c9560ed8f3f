"""xclip_tpu_torch: the PyTorch/CUDA port of xclip_tpu for one NVIDIA H100.

The port serves CLIP inference and trains it (`CLIP(..., return_loss=True)`,
`train.make_train_step`). Plain tensor code is PyTorch; the Pallas kernels
on those paths are hand-written CUDA kernels for Hopper (`csrc/`), built
with nvcc at first use, each training kernel an autograd Function with a
kernel backward. The package never imports JAX; `xclip_tpu` is the
reference it is tested against.
"""

from .api import CLIP
from .model import CLIPModel
from .nn.text import TextTransformer
from .nn.vision import VisionTransformer
from .objectives.mlm import MLM
from .objectives.ssl import SimCLR, SimSiam

__all__ = [
    "CLIP", "CLIPModel", "TextTransformer", "VisionTransformer",
    "MLM", "SimSiam", "SimCLR",
]
