"""The draws of the JAX package's objectives, replayed from its keys, for
the port to be given (JAX's and PyTorch's random numbers never agree):
`CLIPModel.apply(..., rng=rng, training=True, return_loss=True)` gives
`RngStream(rng)`'s keys in order to the MLM (when on), the visual SSL
(when on), the text tower and the vision tower (`model.py:242-277`); the
MLM splits its key in 4 (`mlm.py:79`), SimSiam in 6 and SimCLR in 4
(`ssl.py:204`, `:286`), `default_augment` in 8 (`augment.py:174`), and a
vision tower takes the first half of its key's split for the patch
dropout (`nn/vision.py:86-88`)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def jax_keep_idx(key, b, num_patches, prob):
    """The patch indices a vision tower keeps when given `key`."""
    rng_pd, _ = jax.random.split(key)
    scores = jax.random.uniform(rng_pd, (b, num_patches))
    _, keep = jax.lax.top_k(scores, max(1, int(num_patches * (1 - prob))))
    return torch.from_numpy(np.array(keep))


def jax_augment_draws(key):
    """`default_augment`'s draws for `key`, as `objectives.augment` takes
    them."""
    keys = jax.random.split(key, 8)
    kb, kc, ks, kh, kp = jax.random.split(keys[0], 5)

    def u(k, lo=0.0, hi=1.0):
        return float(jax.random.uniform(k, (), minval=lo, maxval=hi))

    k_area, k_ratio, k_y, k_x = jax.random.split(keys[6], 4)
    return {
        "brightness": u(kb, max(0.0, 1 - 0.8), 1 + 0.8),
        "contrast": u(kc, max(0.0, 1 - 0.8), 1 + 0.8),
        "saturation": u(ks, max(0.0, 1 - 0.8), 1 + 0.8),
        "hue": u(kh, -0.2, 0.2),
        "perm": [int(i) for i in jax.random.permutation(kp, 4)],
        "jitter": u(keys[1]), "grey": u(keys[2]), "flip": u(keys[3]),
        "sigma": u(keys[4], 1.0, 2.0), "blur": u(keys[5]),
        "area": u(k_area, 0.08, 1.0),
        "log_ratio": float(jax.random.uniform(
            k_ratio, (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))),
        "y": u(k_y), "x": u(k_x)}


def jax_mlm_draws(key, shape, num_tokens, random_token_prob=0.0):
    """The MLM's draws for its key."""
    r_subset, r_random, r_replace, _ = jax.random.split(key, 4)
    d = {"subset": jax.random.uniform(r_subset, shape),
         "replace": jax.random.uniform(r_replace, shape)}
    if random_token_prob > 0:
        r_rand_p, r_rand_tok = jax.random.split(r_random)
        d["random"] = jax.random.uniform(r_rand_p, shape)
        d["random_tokens"] = jax.random.randint(r_rand_tok, shape, 0,
                                                num_tokens)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def jax_ssl_draws(key, kind, b, num_patches, prob):
    """SimSiam's or SimCLR's draws for its key: the two views'
    augmentations and the tower passes' patch indices."""
    if kind == "simsiam":
        ka1, ka2, *ke = jax.random.split(key, 6)
    else:
        ka1, ka2, *ke = jax.random.split(key, 4)
    keep = [jax_keep_idx(k, b, num_patches, prob) if prob > 0 else None
            for k in ke]
    return {"augment": [jax_augment_draws(ka1), jax_augment_draws(ka2)],
            "keep_idx": keep}


def jax_draws(rng, *, b, views=1, mlm=None, ssl=None, num_patches=9,
              prob=0.5, seq=16, num_tokens=100, random_token_prob=0.0):
    """All the draws of one training `apply` with `rng`: a dict of the
    port's forward kwargs (`keep_idx`, `mlm_draws`, `ssl_draws`). `mlm`
    True when the MLM is on; `ssl` "simsiam", "simclr" or None; `views`
    the image views of the main pass."""
    count, out = 0, {}
    if mlm:
        out["mlm_draws"] = jax_mlm_draws(jax.random.fold_in(rng, count),
                                         (b, seq), num_tokens,
                                         random_token_prob)
        count += 1
    if ssl:
        out["ssl_draws"] = jax_ssl_draws(jax.random.fold_in(rng, count),
                                         ssl, b, num_patches, prob)
        count += 1
    if prob > 0:
        out["keep_idx"] = jax_keep_idx(jax.random.fold_in(rng, count + 1),
                                       b * views, num_patches, prob)
    return out
