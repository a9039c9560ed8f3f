"""Dataset sources for the input pipeline, the counterpart of
`xclip_tpu/data/sources.py`: the img2dataset-style layout (`xxx.jpg` +
sibling `xxx.txt` caption) as (caption, CHW float32 NumPy image) pairs for
`TextImageLoader`. PIL is imported inside `load_image`, so the rest of the
package works without it.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def load_image(path: str, image_size: int, *,
               normalize: bool = True) -> np.ndarray:
    """Decode → RGB → resize (bicubic, square) → (3, H, W) float32 in [0,1]
    (or ImageNet-normalized when `normalize`)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize((image_size, image_size),
                                      Image.BICUBIC)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    arr = arr.transpose(2, 0, 1)
    if normalize:
        mean = np.array([0.485, 0.456, 0.406], np.float32)[:, None, None]
        std = np.array([0.229, 0.224, 0.225], np.float32)[:, None, None]
        arr = (arr - mean) / std
    return arr


class ImageFolderDataset:
    """(caption, image) pairs from a directory of image files with sibling
    `.txt` caption files (img2dataset layout). Re-iterable; pass directly as
    `TextImageLoader(examples=...)`.

    Args:
      root: directory scanned recursively for image files.
      image_size: square resize target.
      normalize: ImageNet normalization (matches the reference's SSL aug
        pipeline normalization, visual_ssl.py:40-43).
      caption_ext: caption sibling extension; files without one are skipped
        unless `default_caption` is set.
    """

    def __init__(self, root: str, image_size: int, *,
                 normalize: bool = True, caption_ext: str = ".txt",
                 default_caption: Optional[str] = None,
                 shuffle_seed: Optional[int] = None):
        self.root = root
        self.image_size = image_size
        self.normalize = normalize
        self.caption_ext = caption_ext
        self.default_caption = default_caption
        self.shuffle_seed = shuffle_seed
        self._paths = self._scan()

    def _scan(self) -> Sequence[str]:
        """Collect image paths that have a usable caption — filtering here
        (not at iteration) keeps `__getitem__` total, which the loader's
        worker pool and multihost sharding rely on (every index decodes)."""
        paths = []
        for dirpath, _, files in os.walk(self.root):
            for f in sorted(files):
                if not f.lower().endswith(_IMAGE_EXTS):
                    continue
                path = os.path.join(dirpath, f)
                if self.default_caption is None and not os.path.exists(
                        os.path.splitext(path)[0] + self.caption_ext):
                    continue
                paths.append(path)
        return paths

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, i: int) -> Tuple[str, np.ndarray]:
        """Random access (decode on demand) — enables TextImageLoader's
        multi-worker pool, per-epoch shuffles, and per-process sharding."""
        path = self._paths[int(i)]
        cap_path = os.path.splitext(path)[0] + self.caption_ext
        if os.path.exists(cap_path):
            with open(cap_path) as f:
                caption = f.read().strip()
        else:
            caption = self.default_caption
        return caption, load_image(path, self.image_size,
                                   normalize=self.normalize)

    def __call__(self) -> Iterator[Tuple[str, np.ndarray]]:
        return iter(self)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        order = np.arange(len(self._paths))
        if self.shuffle_seed is not None:
            np.random.RandomState(self.shuffle_seed).shuffle(order)
        for i in order:
            yield self[i]
