"""Weights carried across from the JAX package.

The port keeps the JAX layout: linear weights are `(in, out)` and applied
as `x @ w` (the kernels take them without a transpose), and parameter
names are the JAX param tree's keys. The one difference is depth: JAX
stacks the per-layer leaves along a leading `(depth, ...)` axis under
`layers`, the port keeps an `nn.ModuleList`, so `layers.<leaf>` of shape
(depth, ...) becomes `layers.<i>.<leaf>` for each i.

`load_jax_params(model, tree)` fills a port model from the JAX package's
param tree (nested dicts of numpy arrays, JAX arrays converted with
`np.asarray`), strictly. `to_jax_tree(model)` is the reverse map: the
port's parameters, or with `grads=True` their `.grad` (zeros where there
is none, as JAX differentiates every leaf), as a JAX-layout tree of fp32
numpy arrays with the depth axis restacked. `numpy_params(config, seed)` builds such a tree from
`np.random.RandomState(seed)`, the same numbers on every machine, so the
JAX package and the port can be given identical weights without JAX.

The SSL heads' BatchNorm running statistics (`.../bnN/mean`, `var`) are
leaves of JAX's param tree and buffers of the port's modules: both maps
carry them (in `to_jax_tree(grads=True)` as zeros, JAX's gradient of
them). JAX's optimizer state also holds Adam moments for them, zeros at
every step; the port's `AdamW` has none, and no map carries optimizer
state.

A model whose parameters are sharded over a mesh (`parallel.shard_params`)
loads each sharded leaf's shard from the whole JAX tensor
(`parallel.sharding.shard_tensor`), and `to_jax_tree` gathers the shards
back into JAX's layout (`gather_tensor`): then it is collective, and every
rank of the mesh calls it.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from .parallel.sharding import gather_tensor, shard_tensor


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def _unstack(flat):
    """`...layers.<leaf>` of shape (depth, ...) → `...layers.<i>.<leaf>`."""
    out = {}
    for name, value in flat:
        value = np.asarray(value)
        parts = name.split(".")
        if "layers" in parts:
            i = parts.index("layers") + 1
            for d in range(value.shape[0]):
                out[".".join(parts[:i] + [str(d)] + parts[i:])] = value[d]
        else:
            out[name] = value
    return out


def load_jax_params(model, tree) -> None:
    """Copy a JAX `CLIPModel` param tree into `model` (a `CLIP` or a
    `CLIPModel`) in place, cast to each parameter's dtype. Raises on a
    missing key, an unused key or a shape that differs."""
    model = getattr(model, "model", model)
    flat = _unstack(_flatten(tree))
    state = model.state_dict()
    shardings = {name: p.sharding for name, p in model.named_parameters()
                 if getattr(p, "sharding", None) is not None}
    missing = sorted(state.keys() - flat.keys())
    unused = sorted(flat.keys() - state.keys())
    if missing or unused:
        raise KeyError(f"param tree does not match the model: missing "
                       f"{missing}, unused {unused}")
    for name, param in state.items():
        src = torch.from_numpy(np.asarray(flat[name], dtype=np.float32))
        if name in shardings:
            src = shard_tensor(src, shardings[name])
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} in the "
                             f"tree, {tuple(param.shape)} in the model")
        with torch.no_grad():
            param.copy_(src.to(param.dtype))


def _restack(flat):
    """`...layers.<i>.<leaf>` → `...layers.<leaf>` of shape (depth, ...)."""
    stacks, out = {}, {}
    for name, value in flat.items():
        parts = name.split(".")
        if "layers" in parts:
            i = parts.index("layers") + 1
            key = ".".join(parts[:i] + parts[i + 1:])
            stacks.setdefault(key, {})[int(parts[i])] = value
        else:
            out[name] = value
    for key, by_depth in stacks.items():
        out[key] = np.stack([by_depth[d] for d in sorted(by_depth)])
    return out


def to_jax_tree(model, *, grads: bool = False) -> dict:
    """The JAX-layout param tree of `model` (a `CLIP` or a `CLIPModel`) as
    nested dicts of fp32 numpy arrays: its parameters, or their gradients."""
    model = getattr(model, "model", model)
    flat = {}
    for name, param in model.named_parameters():
        t = param.grad if grads else param
        if t is None:
            t = torch.zeros_like(param)
        t = t.detach()
        if getattr(param, "sharding", None) is not None:
            t = gather_tensor(t, param.sharding)
        flat[name] = t.float().cpu().numpy()
    for name, buf in model.named_buffers():   # the BatchNorm statistics
        flat[name] = (torch.zeros_like(buf) if grads else buf).float().cpu(
        ).numpy()
    tree = {}
    for name, value in _restack(flat).items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _clip_defaults():
    from .api import CLIP
    return {k: p.default for k, p in
            inspect.signature(CLIP.__init__).parameters.items()
            if p.default is not inspect.Parameter.empty}


def _ssl_spec(c):
    """(kind, hidden_layer, projection, hidden) of the config's visual SSL
    head, or None: from `visual_ssl_type` / `visual_ssl_hidden_layer`, or
    from a `visual_ssl` instance's fields (the JAX package's or the
    port's)."""
    ssl = c.get("visual_ssl")
    if ssl is not None:
        if hasattr(ssl, "project_dim"):
            return "simclr", ssl.hidden_layer, ssl.project_dim, 4096
        return ("simsiam", ssl.hidden_layer, ssl.projection_size,
                ssl.projection_hidden_size)
    if not c["use_visual_ssl"]:
        return None
    if c["visual_ssl_type"] == "simclr":
        return "simclr", c["visual_ssl_hidden_layer"], 128, 4096
    return "simsiam", c["visual_ssl_hidden_layer"], 256, 4096


def numpy_params(config: dict, seed: int = 0) -> dict:
    """A JAX-layout `CLIPModel` param tree for the `CLIP(**config)` kwargs
    (defaults as `CLIP`'s), drawn from `np.random.RandomState(seed)`: linear
    weights U(±1/sqrt(in)), embeddings N(0, 1), LayerNorm gains 1 + 0.1·N,
    temperature 1; BatchNorm scale 1 + 0.1·N, bias, mean 0.1·N and var
    1 + 0.1·|N|; convolutions U(±1/sqrt(fan_in)). The extra latent heads
    are drawn apart from the main ones, so tests can tell them apart. The
    MLM head, the visual SSL heads and the downsampling latent heads are
    drawn after the rest, where the config has them. fp32 arrays."""
    c = {**_clip_defaults(), **config}
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def lin(d_in, d_out, bias=False):
        bound = 1.0 / math.sqrt(d_in)
        p = {"w": rs.uniform(-bound, bound, (d_in, d_out)).astype(f32)}
        if bias:
            p["b"] = rs.uniform(-bound, bound, (d_out,)).astype(f32)
        return p

    def gain(d):
        return {"g": (1.0 + 0.1 * rs.randn(d)).astype(f32)}

    def emb(n, d):
        return {"emb": rs.randn(n, d).astype(f32)}

    def tower(dim, depth, heads, dim_head, ff_mult=4):
        hd, inner = heads * dim_head, dim * ff_mult
        layers = [{
            "attn": {"norm": gain(dim), "to_qkv": lin(dim, 3 * hd),
                     "to_out": lin(hd, dim), "out_norm": gain(dim)},
            "ff": {"norm": gain(dim), "w_in": lin(dim, 2 * inner),
                   "inner_norm": gain(inner), "w_out": lin(inner, dim)},
        } for _ in range(depth)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)

        return {"layers": stack(*layers), "norm_in": gain(dim),
                "norm_out": gain(dim)}

    def bn(d, affine=True):
        p = {"mean": (0.1 * rs.randn(d)).astype(f32),
             "var": (1.0 + 0.1 * np.abs(rs.randn(d))).astype(f32)}
        if affine:
            p["scale"] = (1.0 + 0.1 * rs.randn(d)).astype(f32)
            p["bias"] = (0.1 * rs.randn(d)).astype(f32)
        return p

    def conv(out_c, in_c, k, bias=False):
        bound = 1.0 / math.sqrt(in_c * k * k)
        p = {"w": rs.uniform(-bound, bound, (out_c, in_c, k, k)).astype(f32)}
        if bias:
            p["b"] = rs.uniform(-bound, bound, (out_c,)).astype(f32)
        return p

    dt, di = c["dim_text"], c["dim_image"]
    p = c["visual_patch_size"]
    # drawn in one order, each leaf only where JAX's TextTransformer.init
    # has it: no absolute positions under rotary, no CLS when causal
    text = {"token_emb": emb(c["num_text_tokens"] + bool(c["use_mlm"]), dt)}
    if not c["text_rotary_pos_emb"]:
        text["abs_pos_emb"] = emb(c["text_seq_len"], dt)
    if not c["text_causal_mask"]:
        text["cls_token"] = rs.randn(dt).astype(f32)
    text["transformer"] = tower(dt, c["text_enc_depth"], c["text_heads"],
                                c["text_dim_head"])
    visual = {"patch_proj": lin(c["channels"] * p * p, di, bias=True),
              "pos_emb": emb((c["visual_image_size"] // p) ** 2, di),
              "transformer": tower(di, c["visual_enc_depth"],
                                   c["visual_heads"], c["visual_dim_head"]),
              "to_cls": lin(di, di)}
    tree = {"text": text, "visual": visual,
            "to_text_latent": lin(dt, c["dim_latent"]),
            "to_visual_latent": lin(di, c["dim_latent"]),
            "to_text_latent_extra": lin(dt, c["dim_latent"]),
            "to_visual_latent_extra": lin(di, c["dim_latent"]),
            "temperature": np.asarray(1.0, dtype=f32)}
    if c["use_mlm"]:
        tree["mlm"] = {"to_logits": lin(dt, c["num_text_tokens"], bias=True)}
    spec = _ssl_spec(c)
    if spec is not None:
        kind, hidden_layer, proj, hidden = spec
        num = (c["visual_image_size"] // p) ** 2
        if c["visual_patch_dropout"] > 0.0:
            num = max(1, int(num * (1 - c["visual_patch_dropout"])))
        rep = di if hidden_layer in (-1, "-1") else num * di
        projector = {"l1": lin(rep, hidden), "bn1": bn(hidden),
                     "l2": lin(hidden, hidden), "bn2": bn(hidden),
                     "l3": lin(hidden, proj), "bn3": bn(proj, affine=False)}
        tree["visual_ssl"] = {"projector": projector}
        if kind == "simsiam":
            tree["visual_ssl"]["predictor"] = {
                "l1": lin(proj, hidden, bias=True), "bn1": bn(hidden),
                "l2": lin(hidden, proj, bias=True)}
    if c["downsample_image_embeds"]:
        for key in ("to_visual_latent", "to_visual_latent_extra"):
            tree[key] = {"dw": conv(di, 1, 4),
                         "pw": conv(c["dim_latent"], di, 1, bias=True)}
    return tree
