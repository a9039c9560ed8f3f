"""Image augmentations for the visual SSL branches — the counterpart of
`xclip_tpu/objectives/augment.py`, op for op, in PyTorch (no torchvision):

    RandomApply(ColorJitter(0.8, 0.8, 0.8, 0.2), p=0.3)   [rgb or greyscale]
    RandomGrayscale(p=0.2)                                 [rgb only]
    RandomHorizontalFlip()
    RandomApply(GaussianBlur((3,3), sigma∈(1,2)), p=0.2)
    RandomResizedCrop(image_size)   (scale 0.08-1.0, ratio 3/4-4/3)
    Normalize(ImageNet mean/std)                           [rgb only]

Every draw is one scalar per batch, as torchvision's on a batch tensor.
They come in a dict (`augment_draws`): `brightness`, `contrast`,
`saturation`, `hue` (the jitter factors), `perm` (the order of the four
jitter ops), the uniforms `jitter`, `grey`, `flip`, `blur` that decide
whether each op applies (below 0.3, 0.2, 0.5, 0.2), `sigma`, and the crop's
`area` (its share of the image), `log_ratio`, `y` and `x` (uniforms that
place it). `augment_draws(generator)` draws them; tests inject the ones
the JAX package draws from its keys.

dtype: the jitter factors are fp32 scalars in JAX, which promote a bf16
image to fp32 in `_blend`, and the `where` that applies the jitter keeps
that, so `default_augment` returns fp32 for an rgb or greyscale batch of
any float dtype; this module does the same.

`random_resized_crop` is `jax.image.scale_and_translate(method='linear',
antialias=False)`: the triangle kernel at sample positions
(o + 0.5)/scale − translate/scale − 0.5, each output's weights divided by
their sum (left 0 when the sum is below 1000 fp32 epsilons), and outputs
whose sample lies outside [−0.5, size − 0.5] set to 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the draws, in the order `augment_draws` takes its uniforms
SCALARS = ("brightness", "contrast", "saturation", "hue", "jitter", "grey",
           "flip", "sigma", "blur", "area", "log_ratio", "y", "x")


def _f32(v):
    """A draw as an fp32 0-d tensor (JAX's draws are fp32 scalars)."""
    return torch.as_tensor(v, dtype=torch.float32)


def rgb_to_grayscale(x):
    """itu-r 601-2 luma with torchvision's weights: (b, 3, h, w) → (b, 1,
    h, w)."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.einsum("bchw,c->bhw", x, w)[:, None]


def _promoted(x):
    """x in its dtype promoted with fp32, as JAX promotes an array met by
    an fp32 draw (PyTorch would keep a 0-d tensor's operand dtype)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _blend(a, b, factor):
    """torchvision's `_blend`, clamped to [0, 1] as for float images; the
    fp32 factor promotes a narrower image."""
    factor = _f32(factor).to(a.device)
    return torch.clamp(_promoted(a) * factor + _promoted(b) * (1.0 - factor),
                       0.0, 1.0)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x, factor):
    grey = rgb_to_grayscale(x) if x.shape[1] == 3 else x
    return _blend(x, grey.mean(dim=(1, 2, 3), keepdim=True), factor)


def adjust_saturation(x, factor):
    if x.shape[1] != 3:
        return x
    return _blend(x, rgb_to_grayscale(x), factor)


def adjust_hue(x, delta):
    """Shift hue by `delta` (a fraction of a turn) through RGB → HSV → RGB,
    JAX's piecewise formulas (`augment.py:74-105`)."""
    if x.shape[1] != 3:
        return x
    delta = _f32(delta).to(x.device)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    spread = maxc - minc
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.where(maxc > 0, spread / torch.clamp(maxc, min=1e-8), zero)
    safe = torch.clamp(spread, min=1e-8)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(spread == 0, zero, h)
    h = torch.remainder(_promoted(h) + delta, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=1)


def color_jitter(x, draws):
    """ColorJitter with the draws' factors, its four ops in the draws'
    permutation (`perm`: 0 brightness, 1 contrast, 2 saturation, 3 hue)."""
    ops = (lambda im: adjust_brightness(im, draws["brightness"]),
           lambda im: adjust_contrast(im, draws["contrast"]),
           lambda im: adjust_saturation(im, draws["saturation"]),
           lambda im: adjust_hue(im, draws["hue"]))
    for j in draws["perm"]:
        x = ops[int(j)](x)
    return x


def gaussian_blur3(x, sigma):
    """3×3 gaussian blur, depthwise, after REFLECT padding."""
    r = torch.tensor([-1.0, 0.0, 1.0])
    k1 = torch.exp(-(r ** 2) / (2 * _f32(sigma) ** 2))
    k1 = k1 / k1.sum()
    c = x.shape[1]
    kernel = torch.outer(k1, k1).to(x.dtype).to(x.device)
    kernel = kernel.expand(c, 1, 3, 3)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), kernel,
                    groups=c)


def _weight_mat(in_size, out_size, scale, translation):
    """`compute_weight_mat` (jax.image) for the linear kernel without
    antialiasing: (in_size, out_size) fp32."""
    inv_scale = 1.0 / scale
    sample = ((torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale
              - translation * inv_scale - 0.5)
    dist = torch.abs(sample[None, :]
                     - torch.arange(in_size, dtype=torch.float32)[:, None])
    weights = torch.clamp(1.0 - torch.abs(dist), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0),
        torch.zeros(()))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros(()))


def random_resized_crop(x, out_size: int, draws, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)):
    """One fractional box per batch from the draws (`area`: the uniform of
    [scale], `log_ratio`, `y`, `x`), clipped into the image and resampled
    bilinearly to out_size × out_size."""
    b, c, h, w = x.shape
    area = _f32(draws["area"]) * h * w
    aspect = torch.exp(_f32(draws["log_ratio"]))
    crop_w = torch.clamp(torch.sqrt(area * aspect), 1.0, float(w))
    crop_h = torch.clamp(torch.sqrt(area / aspect), 1.0, float(h))
    y0 = _f32(draws["y"]) * (h - crop_h)
    x0 = _f32(draws["x"]) * (w - crop_w)
    scale_y, scale_x = out_size / crop_h, out_size / crop_w
    wy = _weight_mat(h, out_size, scale_y, -y0 * scale_y)
    wx = _weight_mat(w, out_size, scale_x, -x0 * scale_x)
    wy, wx = (m.to(x.dtype).to(x.device) for m in (wy, wx))
    return torch.einsum("bchw,hy,wx->bcyx", x, wy, wx)


def augment_draws(generator=None, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """The draws of one `default_augment` call, from `generator` (on its
    device; one host read): the distributions of JAX's draws."""
    device = generator.device if generator is not None else "cpu"
    u = torch.rand(len(SCALARS), generator=generator, device=device).tolist()
    perm = torch.randperm(4, generator=generator, device=device).tolist()
    d = dict(zip(SCALARS, u))
    for k in ("brightness", "contrast", "saturation"):
        d[k] = 0.2 + 1.6 * d[k]
    d["hue"] = -0.2 + 0.4 * d["hue"]
    d["sigma"] = 1.0 + d["sigma"]
    d["area"] = scale[0] + (scale[1] - scale[0]) * d["area"]
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    d["log_ratio"] = lo + (hi - lo) * d["log_ratio"]
    d["perm"] = perm
    return d


def default_augment(x, image_size: int, channels: int = 3, *,
                    generator=None, draws=None):
    """The default SSL pipeline (`augment.py:170-199`) on an NCHW batch,
    with `draws` (see the module docstring) or draws from `generator`."""
    if draws is None:
        draws = augment_draws(generator)
    is_rgb = channels == 3
    if channels in (1, 3):
        jittered = color_jitter(x, draws)
        x = jittered if draws["jitter"] < 0.3 else x.to(jittered.dtype)
    if is_rgb and draws["grey"] < 0.2:
        x = rgb_to_grayscale(x).expand(x.shape).contiguous()
    if draws["flip"] < 0.5:
        x = torch.flip(x, dims=(-1,))
    if draws["blur"] < 0.2:
        x = gaussian_blur3(x, draws["sigma"])
    x = random_resized_crop(x, image_size, draws)
    if is_rgb:
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean[None, :, None, None]) / std[None, :, None, None]
    return x
