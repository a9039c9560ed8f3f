"""The port's MLM against the JAX package on the CPU, given the draws JAX
takes from its keys (`torch_objectives_draws.jax_mlm_draws`): the mask
subset (ties among ineligible positions, short rows, an all-pad row), the
corrupted sequence and labels with and without random-token corruption,
the loss and every gradient through a 2-layer text tower, a batch with no
maskable token (0, not NaN), and `CLIP`'s `mlm_*` kwargs.

Tolerances (fp32): masks, sequences and labels exactly; the loss 1e-5;
gradients rtol 1e-3 with atol 1e-5 of the leaf's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xclip_tpu
from xclip_tpu.nn.text import TextTransformer as JText
from xclip_tpu.objectives import mlm as jmlm
import xclip_tpu_torch
from xclip_tpu_torch.convert import _flatten, _restack, _unstack
from xclip_tpu_torch.nn.text import TextTransformer
from xclip_tpu_torch.objectives import mlm as tmlm

from torch_objectives_draws import jax_mlm_draws
import torch_one_thread  # noqa: F401

jax.config.update("jax_default_matmul_precision", "highest")


def _text(b=5, n=16, seed=0, vocab=100):
    npr = np.random.RandomState(seed)
    text = npr.randint(1, vocab, (b, n))
    for i in range(b):
        text[i, n - 3 * i:] = 0          # padded captions of mixed lengths
    text[-1] = 0                          # an all-pad row
    text[0, :4] = (3, 3, 5, 3)            # tokens to ignore
    return text


@pytest.mark.parametrize("prob", [0.15, 0.5, 1.0])
def test_mask_subset_matches_jax(prob):
    text = _text(seed=1)
    mask = text != 0
    key = jax.random.PRNGKey(int(prob * 100))
    want = jmlm.get_mask_subset_with_prob(key, jnp.asarray(mask), prob)
    u = torch.from_numpy(np.array(jax.random.uniform(key, text.shape)))
    got = tmlm.get_mask_subset_with_prob(torch.from_numpy(mask), prob, u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("random_token_prob", [0.0, 0.3])
def test_masked_sequence_matches_jax(random_token_prob):
    """The corrupted sequence and labels JAX's `apply` builds (recovered
    from a text tower that returns its input ids as embeddings)."""
    text = _text(seed=2)
    kw = dict(dim=8, num_tokens=100, mask_prob=0.3,
              random_token_prob=random_token_prob, mask_token_id=2,
              mask_ignore_token_ids=(3,))
    key = jax.random.PRNGKey(7)
    seen = {}

    class Spy:
        def apply(self, params, seq, mask, **_):
            seen["seq"] = np.asarray(seq)
            return jnp.zeros((*seq.shape[:1], seq.shape[1] + 1, 8))

    jm = jmlm.MLM(**kw)
    jm.apply(jm.init(jax.random.PRNGKey(0)), Spy(), None, jnp.asarray(text),
             mask=jnp.asarray(text != 0), rng=key)
    tm = tmlm.MLM(**kw)
    draws = jax_mlm_draws(key, text.shape, 100, random_token_prob)
    seq, labels = tm.masked(torch.from_numpy(text), draws)
    np.testing.assert_array_equal(seq.numpy(), seen["seq"])
    assert (seq.numpy() != text).any()
    # labels: the originals where the subset picked them, else pad
    subset = tmlm.get_mask_subset_with_prob(
        torch.from_numpy(~np.isin(text, (0, 3))), 0.3, draws["subset"])
    np.testing.assert_array_equal(labels.numpy(),
                                  np.where(subset.numpy(), text, 0))


TEXT = dict(dim=64, num_tokens=101, max_seq_len=16, depth=2, heads=2,
            dim_head=32)


def _tower_pair(ff_impl="xla"):
    jtower = JText(**TEXT, ff_impl=ff_impl)
    tp = jtower.init(jax.random.PRNGKey(3))
    ttower = TextTransformer(**TEXT, ff_impl=ff_impl)
    flat = _unstack(_flatten(jax.tree.map(np.asarray, tp)))
    state = ttower.state_dict()
    assert flat.keys() == state.keys()
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(torch.from_numpy(np.array(flat[k])))
    return jtower, tp, ttower


@pytest.mark.parametrize("random_token_prob", [0.0, 0.2])
def test_loss_and_grads_match_jax(random_token_prob):
    jtower, tp, ttower = _tower_pair()
    kw = dict(dim=64, num_tokens=100, random_token_prob=random_token_prob,
              mask_prob=0.25)
    jm = jmlm.MLM(**kw)
    hp = jm.init(jax.random.PRNGKey(4))
    tm = tmlm.MLM(**kw)
    with torch.no_grad():
        tm.to_logits.w.copy_(torch.from_numpy(np.asarray(hp["to_logits"]["w"])))
        tm.to_logits.b.copy_(torch.from_numpy(np.asarray(hp["to_logits"]["b"])))
    text = _text(seed=3)
    key = jax.random.PRNGKey(11)

    def loss(p):
        return jm.apply(p["mlm"], jtower, p["text"], jnp.asarray(text),
                        mask=jnp.asarray(text != 0), rng=key)

    want, grads = jax.value_and_grad(loss)({"mlm": hp, "text": tp})
    got = tm(ttower, torch.from_numpy(text),
             mask=torch.from_numpy(text != 0),
             draws=jax_mlm_draws(key, text.shape, 100, random_token_prob))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    pairs = [(tm.to_logits.w.grad, grads["mlm"]["to_logits"]["w"]),
             (tm.to_logits.b.grad, grads["mlm"]["to_logits"]["b"])]
    tower = _restack({n: p.grad.numpy() for n, p in
                      ttower.named_parameters()})
    flat = dict(_flatten(jax.tree.map(np.asarray, grads["text"])))
    assert tower.keys() == flat.keys()
    pairs += [(torch.from_numpy(tower[k]), flat[k]) for k in flat]
    for g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-3,
            atol=1e-5 * max(1.0, float(np.abs(w).max())))


def test_no_maskable_token_gives_zero():
    """Every row all pad: no label counts, the loss is 0 (the count is
    clipped to 1), and its gradient is finite."""
    jtower, tp, ttower = _tower_pair()
    jm, tm = jmlm.MLM(dim=64, num_tokens=100), tmlm.MLM(dim=64,
                                                        num_tokens=100)
    text = np.zeros((3, 16), np.int64)
    key = jax.random.PRNGKey(2)
    want = jm.apply(jm.init(jax.random.PRNGKey(0)), jtower, tp,
                    jnp.asarray(text), mask=jnp.asarray(text != 0), rng=key)
    got = tm(ttower, torch.from_numpy(text),
             mask=torch.from_numpy(text != 0),
             draws=jax_mlm_draws(key, text.shape, 100))
    got.backward()
    assert float(want) == 0.0 and got.item() == 0.0
    assert all(torch.isfinite(p.grad).all() for p in ttower.parameters()
               if p.grad is not None)


def test_draws_from_a_generator():
    tm = tmlm.MLM(dim=8, num_tokens=50, random_token_prob=0.1)
    seq = torch.from_numpy(_text(seed=4, vocab=50))
    d = tm.draws(seq, torch.Generator().manual_seed(0))
    assert set(d) == {"subset", "replace", "random", "random_tokens"}
    assert all(v.shape == seq.shape for v in d.values())
    assert int(d["random_tokens"].max()) < 50


def test_clip_mlm_kwargs_route_as_jax():
    """`mlm_*` kwargs reach the MLM (`mask_ignore_token_ids` as a tuple),
    the text tower takes one more token for the mask id, and an `mlm_`
    kwarg without `use_mlm` is unexpected, as in JAX."""
    cfg = dict(dim_text=64, dim_image=64, dim_latent=64,
               num_text_tokens=100, text_enc_depth=1, text_seq_len=16,
               text_heads=2, visual_enc_depth=1, visual_heads=2,
               visual_image_size=32, visual_patch_size=16, use_mlm=True,
               mlm_mask_prob=0.4, mlm_mask_ignore_token_ids=[5, 6],
               mlm_random_token_prob=0.1)
    jclip = xclip_tpu.CLIP(**cfg)
    tclip = xclip_tpu_torch.CLIP(**cfg, device="cpu")
    jm, tm = jclip.model.mlm, tclip.model.mlm
    for k in ("mask_prob", "random_token_prob", "mask_ignore_token_ids",
              "replace_prob", "mask_token_id", "pad_token_id", "num_tokens",
              "dim"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert tm.mask_ignore_token_ids == (5, 6)
    assert tclip.model.text.token_emb.emb.shape == (101, 64)
    assert tclip.model.mlm.to_logits.w.shape == (64, 100)
    for make in (xclip_tpu.CLIP, lambda **k: xclip_tpu_torch.CLIP(
            **k, device="cpu")):
        with pytest.raises(TypeError, match="mlm_mask_prob"):
            make(**{**cfg, "use_mlm": False})
