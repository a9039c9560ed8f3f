"""The input pipeline of the port (`xclip_tpu.data`'s counterpart): the BPE
tokenizer, image sources and `TextImageLoader`. Importing it builds and
reads nothing; `tokenizer`, the shared `SimpleTokenizer`, is made at first
use."""

from . import tokenizer as _tokenizer
from .pipeline import TextImageLoader
from .sources import ImageFolderDataset, load_image
from .tokenizer import SimpleTokenizer

# the import bound the submodule to this name: `tokenizer` is the shared
# instance, as in xclip_tpu.data, built by __getattr__ below
del tokenizer  # noqa: F821

__all__ = ["ImageFolderDataset", "SimpleTokenizer", "TextImageLoader",
           "load_image", "tokenizer"]


def __getattr__(name):
    if name == "tokenizer":
        return _tokenizer.tokenizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
