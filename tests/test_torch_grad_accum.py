"""`make_train_step(grad_accum=k)` and `step(..., valid=)` against the JAX
package on the CPU (fp32, the tiny CLIP of `test_torch_train.py`):

  * `grad_accum=2` against JAX's `make_train_step(grad_accum=2)` over two
    steps: metrics within 1e-5, parameters within 2e-6 (the tolerances of
    `test_torch_train.py`), each microbatch given the patches JAX draws
    from its own key; the accumulated gradient bit for bit (g₁ + g₂) / 2
    of two separate half-batch backwards, and the update bit for bit the
    optimizer applied to it; JAX's warning and assertions, in its words;
  * `valid=` against JAX's `row_valid` under `loss_impl='xla'`: loss 1e-5,
    gradients rtol 1e-3 with atol 1e-5 of the leaf's largest magnitude;
    the padded batch's loss within 1e-6 of the truncated batch's, its
    gradients as close as the JAX tolerance; the refusal under
    `loss_impl='fused'` in JAX's words.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xclip_tpu.train import trainer as jtrainer
from xclip_tpu_torch.convert import to_jax_tree
from xclip_tpu_torch.train import default_optimizer, make_train_step

from test_torch_train import _inputs, _pair, _tree_close, jax_keep_idx

jax.config.update("jax_default_matmul_precision", "highest")


def _micro_keep(rng, b, accum):
    """The patches JAX's accumulating step draws: microbatch i's forward
    takes key i of `split(rng, accum)`."""
    return torch.cat([jax_keep_idx(r, b // accum, 9, 0.5)
                      for r in jax.random.split(rng, accum)])


def _warning_of(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in caught]


def test_grad_accum_matches_jax():
    jclip, params, tclip = _pair(seed=4)
    text, image = _inputs(b=4, seed=4)
    sched = dict(learning_rate=1e-4, warmup_steps=2, total_steps=5)
    jopt = jtrainer.default_optimizer(**sched)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False,
                                     grad_accum=2)
    step = make_train_step(tclip, default_optimizer(tclip.parameters(),
                                                    **sched), grad_accum=2)
    for i in range(2):
        rng = jax.random.PRNGKey(40 + i)
        state, want = jstep(state, jnp.asarray(text), jnp.asarray(image), rng)
        got = step(torch.from_numpy(text), torch.from_numpy(image),
                   keep_idx=_micro_keep(rng, 4, 2))
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        _tree_close(to_jax_tree(tclip), state.params, atol=2e-6)


def test_grad_accum_is_the_mean_of_the_microbatch_gradients():
    _, _, tclip = _pair(seed=5)
    _, _, twin = _pair(seed=5)
    text, image = map(torch.from_numpy, _inputs(b=4, seed=5))
    keep = torch.from_numpy(
        np.random.RandomState(5).rand(4, 9).argsort(1)[:, :4])
    halves = []
    for rows in (slice(0, 2), slice(2, 4)):
        twin.zero_grad(set_to_none=True)
        twin(text[rows], image[rows], return_loss=True,
             keep_idx=keep[rows]).backward()
        halves.append({n: p.grad.clone() for n, p in twin.named_parameters()
                       if p.grad is not None})
    with pytest.warns(UserWarning):
        step = make_train_step(tclip, default_optimizer(tclip.parameters()),
                               grad_accum=2)
    step(text, image, keep_idx=keep)
    grads = {n: p.grad for n, p in tclip.named_parameters()
             if p.grad is not None}
    assert grads.keys() == halves[0].keys()
    for k in grads:
        assert torch.equal(grads[k], (halves[0][k] + halves[1][k]) / 2), k
    # the update: the optimizer applied to that gradient
    opt = default_optimizer(twin.parameters())
    for n, p in twin.named_parameters():
        p.grad = grads[n].clone() if n in grads else None
    opt.step()
    for (n, p), q in zip(tclip.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n


def test_grad_accum_warning_and_assertions_are_jax_words():
    jclip, params, tclip = _pair(seed=0)
    jopt = jtrainer.default_optimizer()
    want = _warning_of(lambda: jtrainer.make_train_step(
        jclip.model, jopt, grad_accum=3))
    got = _warning_of(lambda: make_train_step(
        tclip, default_optimizer(tclip.parameters()), grad_accum=3))
    assert got == want and len(want) == 1
    text, image = _inputs(b=4, seed=0)
    state = jtrainer.TrainState(params=params, opt_state=jopt.init(params),
                                step=jnp.zeros((), jnp.int32))
    jstep = jtrainer.make_train_step(jclip.model, jopt, donate=False,
                                     grad_accum=3)
    step = make_train_step(tclip, default_optimizer(tclip.parameters()),
                           grad_accum=3)
    jstep2 = jtrainer.make_train_step(jclip.model, jopt, donate=False,
                                      grad_accum=2)
    step2 = make_train_step(tclip, default_optimizer(tclip.parameters()),
                            grad_accum=2)
    valid = np.ones(4, dtype=bool)
    for jfn, fn, v in ((jstep, step, None), (jstep2, step2, valid)):
        with pytest.raises(AssertionError) as want:
            jfn(state, jnp.asarray(text), jnp.asarray(image),
                jax.random.PRNGKey(0),
                None if v is None else jnp.asarray(v))
        with pytest.raises(AssertionError) as got:
            fn(torch.from_numpy(text), torch.from_numpy(image),
               valid=None if v is None else torch.from_numpy(v))
        assert str(got.value) == str(want.value)


def _valid():
    valid = np.ones(4, dtype=bool)
    valid[3] = False
    return valid


@pytest.mark.parametrize("flags", [{}, dict(
    decoupled_contrastive_learning=True, extra_latent_projection=True)],
    ids=["plain", "dcl-extra"])
def test_valid_matches_jax(flags):
    jclip, params, tclip = _pair(seed=6, **flags)
    text, image = _inputs(b=4, seed=6)
    valid = _valid()
    rng = jax.random.PRNGKey(17)

    def loss_fn(p):
        return jclip.model.apply(p, jnp.asarray(text), jnp.asarray(image),
                                 return_loss=True, rng=rng, training=True,
                                 row_valid=jnp.asarray(valid))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    keep = jax_keep_idx(rng, 4, 9, 0.5)
    loss = tclip(torch.from_numpy(text), torch.from_numpy(image),
                 return_loss=True, keep_idx=keep,
                 row_valid=torch.from_numpy(valid))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    _tree_close(to_jax_tree(tclip, grads=True), want_grads, rtol=1e-3,
                atol_scale=1e-5)
    # the padded batch scores as the truncated batch of its valid rows
    _, _, short = _pair(seed=6, **flags)
    short_loss = short(torch.from_numpy(text[:3]), torch.from_numpy(image[:3]),
                       return_loss=True, keep_idx=keep[:3])
    short_loss.backward()
    np.testing.assert_allclose(loss.item(), short_loss.item(), rtol=1e-6)
    _tree_close(to_jax_tree(tclip, grads=True),
                to_jax_tree(short, grads=True), rtol=1e-3, atol_scale=1e-5)


def test_valid_is_refused_under_the_fused_loss():
    jclip, params, tclip = _pair(seed=0, loss_impl="fused")
    text, image = _inputs(b=4, seed=0)
    valid = _valid()
    with pytest.raises(AssertionError) as want:
        jclip.model.apply(params, jnp.asarray(text), jnp.asarray(image),
                          return_loss=True, rng=jax.random.PRNGKey(0),
                          training=True, row_valid=jnp.asarray(valid))
    step = make_train_step(tclip, default_optimizer(tclip.parameters()))
    with pytest.raises(AssertionError) as got:
        step(torch.from_numpy(text), torch.from_numpy(image),
             valid=torch.from_numpy(valid))
    assert str(got.value) == str(want.value)
