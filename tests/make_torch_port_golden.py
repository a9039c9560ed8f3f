"""Write `tests/data/torch_port_golden.npz`,
`tests/data/torch_port_golden_rotary.npz`,
`tests/data/torch_port_golden_ff.npz` and
`tests/data/torch_port_golden_objectives.npz`: the JAX package's outputs for a
tiny CLIP on numpy-seeded weights, for the PyTorch port to be held to on a
machine without JAX (`tests/test_torch_golden.py` on the CPU, phases 3, 7,
10, 13, 17 and 23 of `chip_smoke.py` on the GPU); and
`tests/data/torch_port_golden_tokens.npz`, JAX's BPE ids of 512 captions
(`tests/test_torch_tokenizer.py`, phase 25).

Regenerate them on a machine with JAX (the repo's CPU environment will do;
Pallas runs in interpret mode), from the repo root:

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py

or only the fourth file with the argument `objectives`, the fifth with
`tokens`.

The first file holds the config, the weight seed, the inputs and the
outputs (scores, latents, the first rows of both encodings); the weights
are rebuilt from the seed with `xclip_tpu_torch.convert.numpy_params`. It
also holds one training step of JAX's `make_train_step` with
`default_optimizer(**TRAIN_OPTIMIZER)`: the batch, the patch indices its
rng keeps (replayed as `CLIPModel.apply` draws them), the loss and
pre-clip gradient norm, every gradient (`grad/<path>`) and every parameter
after the step (`param1/<path>`), paths joined by "/". The same step on the
memory-lean routes (`LEAN_ROUTES`: K3 in both towers, the recompute FF
block, the streaming-LSE InfoNCE) from the same weights, batch and patch
indices is stored under `lean_config`, `lean_train_loss`,
`lean_train_grad_norm`, `lean_grad/<path>` and `lean_param1/<path>`.

The second file is the rotary, causal-EOS text tower (`ROTARY`: rotary
embeddings, no CLS, EOS pooling at the vocabulary's last id) on two routes,
`ROTARY_ROUTES`: "fused" (K6 in the text tower, the plain vision tower, K1)
and "flash" (K7 in both towers, K1). Captions end in EOS then pads, and one
row of each batch has no EOS (it pools its last non-pad token). Per route
<r>: `<r>_config`, the outputs as above under `<r>_`, and one train step
under `<r>_train_loss`, `<r>_train_grad_norm`, `<r>_grad/<path>` and
`<r>_param1/<path>`; the seed, the inputs, the batch, its patch indices and
the optimizer once.

The third file holds the two remaining FF routes in the same layout:
"fused" (`ff_impl='fused'`, the GEGLU + inner-LayerNorm kernel K8, in both
towers beside the megablock) with its outputs and one train step, and
"stored_h" (the kernel routes with `XCLIP_FF_STORE=h`, the stored-h FF
block K1-h) with one train step and `stored_h_env`, the environment the
step was taken under (JSON), which a loader sets around its own step.

The fourth, `tests/data/torch_port_golden_objectives.npz`, is a tiny CLIP
with every objective that combines (`OBJECTIVES`: MLM, a small SimSiam,
sim-reg, DCL, the extra heads, K5's loss) on the kernel routes in both
towers, fp32, one head a layer: `config` and `ssl` (the SimSiam's fields,
JSON), the seed, the batch (`text`, `images`, one augmented view of each
`aug_text`, `aug_images`) and every draw of the training forward, replayed
from JAX's key as `tests/torch_objectives_draws.py` does (`keep_idx`,
`mlm/<name>`, `ssl_keep_idx/<i>`, `ssl_augment` JSON); the forward's loss
and metrics (`metric/<name>`), every gradient (`grad/<path>`), and one
step, composed as `make_train_step` composes it (JAX's step takes no
augmented views): `train_grad_norm` and every parameter and BatchNorm
statistic after it (`param1/<path>`).

The fifth, `tests/data/torch_port_golden_tokens.npz`, holds
`token_captions()` (edge cases of the pre-tokenizer, then seeded captions
of 5-60 words from many scripts) as UTF-8 bytes `caption_bytes` cut at
`caption_offsets`, and the ids of JAX's `SimpleTokenizer.encode` (the
Python merge loop) as `ids` cut at `id_offsets`.
"""

import json
import os
import sys
from pathlib import Path
from unittest import mock

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import xclip_tpu  # noqa: E402
from xclip_tpu.train import trainer  # noqa: E402
from xclip_tpu_torch.convert import numpy_params  # noqa: E402

OUT = Path(__file__).resolve().parent / "data" / "torch_port_golden.npz"
OUT_ROTARY = OUT.with_name("torch_port_golden_rotary.npz")
OUT_FF = OUT.with_name("torch_port_golden_ff.npz")
OUT_OBJECTIVES = OUT.with_name("torch_port_golden_objectives.npz")
OUT_TOKENS = OUT.with_name("torch_port_golden_tokens.npz")
# dim and inner multiples of 64 and dim_head 64, so the CUDA kernels take it
CONFIG = dict(dim_text=64, dim_image=64, dim_latent=64, num_text_tokens=100,
              text_enc_depth=2, text_seq_len=16, text_heads=2,
              visual_enc_depth=2, visual_heads=2, visual_image_size=32,
              visual_patch_size=16, attn_impl="fused",
              visual_attn_impl="xla", ff_impl="block_stored")
SEED = 11
TRAIN_OPTIMIZER = dict(learning_rate=1e-4, warmup_steps=2, total_steps=10)
TRAIN_RNG = 7
LEAN_ROUTES = dict(attn_impl="fused_recompute", visual_attn_impl=None,
                   ff_impl="block", loss_impl="fused")
EOS = 99   # the last id of the 100-token vocabulary
ROTARY = {**{k: v for k, v in CONFIG.items() if not k.endswith("_impl")},
          "text_rotary_pos_emb": True, "text_causal_mask": True,
          "text_eos_id": EOS}
ROTARY_ROUTES = {
    "fused": dict(attn_impl="fused", visual_attn_impl="xla",
                  ff_impl="block_stored"),
    "flash": dict(attn_impl="flash", ff_impl="block_stored")}
FF_ROUTES = {
    "fused": {**CONFIG, "ff_impl": "fused"},
    "stored_h": CONFIG}
STORED_H_ENV = {"XCLIP_FF_STORE": "h"}
OBJECTIVES = {**{k: v for k, v in CONFIG.items() if not k.endswith("_impl")},
              "text_heads": 1, "visual_heads": 1, "attn_impl": "fused",
              "ff_impl": "block_stored", "loss_impl": "fused",
              "use_mlm": True, "decoupled_contrastive_learning": True,
              "extra_latent_projection": True, "sim_reg_loss_weight": 0.1}
OBJECTIVES_SSL = dict(image_size=32, hidden_layer=-1, projection_size=32,
                      projection_hidden_size=64)
METRICS = ("loss", "cl_loss", "text_ssl_loss", "image_ssl_loss",
           "multiview_cl_loss", "sim_reg_loss", "temperature")


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, np.float32)


def keep_idx(rng, b, num_patches, prob):
    """The patch indices `CLIPModel.apply(..., rng=rng, training=True)`
    keeps: the vision tower takes `RngStream(rng)`'s second key and draws
    uniform scores from the first half of its split."""
    rng_pd, _ = jax.random.split(jax.random.fold_in(rng, 1))
    scores = jax.random.uniform(rng_pd, (b, num_patches))
    _, idx = jax.lax.top_k(scores, max(1, int(num_patches * (1 - prob))))
    return np.asarray(idx)


def batch_keys(text, images):
    """The train step's batch, its patch indices and the optimizer."""
    num_patches = (CONFIG["visual_image_size"]
                   // CONFIG["visual_patch_size"]) ** 2
    return {"train_optimizer": json.dumps(TRAIN_OPTIMIZER),
            "train_text": text, "train_images": images,
            "train_keep_idx": keep_idx(jax.random.PRNGKey(TRAIN_RNG),
                                       text.shape[0], num_patches, 0.5)}


def train_step(clip, params, text, images, prefix=""):
    """One step of make_train_step; keys under `prefix` (the batch and
    patch indices only for the first config, which the others share)."""
    rng = jax.random.PRNGKey(TRAIN_RNG)
    jt, ji = jnp.asarray(text), jnp.asarray(images)

    def loss_fn(p):
        return clip.model.apply(p, jt, ji, return_loss=True, rng=rng,
                                training=True)

    grads = jax.grad(loss_fn)(params)
    opt = trainer.default_optimizer(**TRAIN_OPTIMIZER)
    state = trainer.TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
    step = trainer.make_train_step(clip.model, opt, donate=False)
    state, metrics = step(state, jt, ji, rng)
    out = {f"{prefix}train_loss": np.asarray(metrics["loss"]),
           f"{prefix}train_grad_norm": np.asarray(metrics["grad_norm"])}
    if not prefix:
        out.update(batch_keys(text, images))
    out.update({f"{prefix}grad/{k}": v for k, v in flat(grads)})
    out.update({f"{prefix}param1/{k}": v for k, v in flat(state.params)})
    return out


def outputs(clip, params, text, images, prefix=""):
    """Scores, latents and the first rows of both encodings."""
    jt, ji = jnp.asarray(text), jnp.asarray(images)
    tl, il = clip(jt, ji, return_latents=True, params=params)
    et, ei = clip(jt, ji, return_encodings=True, params=params)
    return {f"{prefix}sims": np.asarray(clip(jt, ji, params=params)),
            f"{prefix}text_latents": np.asarray(tl),
            f"{prefix}image_latents": np.asarray(il),
            f"{prefix}enc_text_head": np.asarray(et[:, :3]),
            f"{prefix}enc_image_head": np.asarray(ei[:, :3])}


def captions(npr, b, step):
    """Token ids below EOS with row i cut to 16 - step·i tokens; rows but
    the second end in EOS then pads, the second has no EOS."""
    text = npr.randint(1, EOS, (b, 16))
    for i in range(b):
        end = 16 - step * i
        text[i, end:] = 0
        if i != 1:
            text[i, end - 1] = EOS
    return text


def write_rotary():
    npr = np.random.RandomState(SEED + 3)
    text, images = captions(npr, 4, 3), npr.randn(4, 3, 32, 32).astype(
        np.float32)
    train_text = captions(npr, 6, 2)
    train_images = npr.randn(6, 3, 32, 32).astype(np.float32)
    params = jax.tree.map(jnp.asarray, numpy_params(ROTARY, SEED))
    out = {"seed": SEED, "text": text, "images": images,
           **batch_keys(train_text, train_images)}
    for route, flags in ROTARY_ROUTES.items():
        config = {**ROTARY, **flags}
        clip = xclip_tpu.CLIP(**config)
        out[f"{route}_config"] = json.dumps(config)
        out.update(outputs(clip, params, text, images, f"{route}_"))
        out.update(train_step(clip, params, train_text, train_images,
                              f"{route}_"))
    np.savez_compressed(OUT_ROTARY, **out)
    print(f"wrote {OUT_ROTARY} ({OUT_ROTARY.stat().st_size} bytes)")


def write_ff():
    npr = np.random.RandomState(SEED + 4)
    text = npr.randint(1, 100, (4, 16))
    for i in range(4):
        text[i, 16 - 3 * i:] = 0
    # images on the float16 grid, stored as float16 (read back as float32):
    # the file stays within the size of the other two
    images = npr.randn(4, 3, 32, 32).astype(np.float16)
    train_text = npr.randint(1, 100, (6, 16))
    for i in range(6):
        train_text[i, 16 - 2 * i:] = 0
    train_images = npr.randn(6, 3, 32, 32).astype(np.float16)
    params = jax.tree.map(jnp.asarray, numpy_params(CONFIG, SEED))
    out = {"seed": SEED, "text": text, "images": images,
           **batch_keys(train_text, train_images)}
    images, train_images = (a.astype(np.float32)
                            for a in (images, train_images))
    for route, config in FF_ROUTES.items():
        clip = xclip_tpu.CLIP(**config)
        out[f"{route}_config"] = json.dumps(config)
        if route == "fused":
            out.update(outputs(clip, params, text, images, f"{route}_"))
            out.update(train_step(clip, params, train_text, train_images,
                                  f"{route}_"))
            continue
        out[f"{route}_env"] = json.dumps(STORED_H_ENV)
        # read when the layers trace
        with mock.patch.dict(os.environ, STORED_H_ENV):
            out.update(train_step(clip, params, train_text, train_images,
                                  f"{route}_"))
    np.savez_compressed(OUT_FF, **out)
    print(f"wrote {OUT_FF} ({OUT_FF.stat().st_size} bytes)")


def write_objectives():
    import optax
    from xclip_tpu.objectives.ssl import SimSiam
    from torch_objectives_draws import jax_draws
    npr = np.random.RandomState(SEED + 5)
    b = 4
    text = npr.randint(1, 100, (b, 16))
    for i in range(b):
        text[i, 16 - 3 * i:] = 0
    aug_text = npr.randint(1, 100, (b, 16))
    images, aug_images = (npr.rand(b, 3, 32, 32).astype(np.float32)
                          for _ in range(2))
    ssl = SimSiam(**OBJECTIVES_SSL)
    clip = xclip_tpu.CLIP(**OBJECTIVES, visual_ssl=ssl)
    params = jax.tree.map(jnp.asarray,
                          numpy_params({**OBJECTIVES, "visual_ssl": ssl},
                                       SEED))
    rng = jax.random.PRNGKey(TRAIN_RNG)

    def loss_fn(p):
        return clip.model.apply(
            p, jnp.asarray(text), jnp.asarray(images),
            aug_text=(jnp.asarray(aug_text),),
            aug_image=(jnp.asarray(aug_images),), return_loss=True,
            rng=rng, training=True, return_metrics=True)

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = trainer.default_optimizer(**TRAIN_OPTIMIZER)
    updates, _ = opt.update(grads, opt.init(params), params)
    params1 = trainer._merge_bn_stats(optax.apply_updates(params, updates),
                                      metrics["bn_updates"])
    draws = jax_draws(rng, b=b, views=2, mlm=True, ssl="simsiam",
                      num_patches=4, prob=0.5)
    out = {"config": json.dumps(OBJECTIVES),
           "ssl": json.dumps(OBJECTIVES_SSL), "seed": SEED,
           "train_optimizer": json.dumps(TRAIN_OPTIMIZER), "text": text,
           "images": images, "aug_text": aug_text, "aug_images": aug_images,
           "keep_idx": draws["keep_idx"].numpy(),
           "ssl_augment": json.dumps(draws["ssl_draws"]["augment"]),
           "train_grad_norm": np.asarray(optax.global_norm(grads))}
    out.update({f"mlm/{k}": v.numpy()
                for k, v in draws["mlm_draws"].items()})
    out.update({f"ssl_keep_idx/{i}": k.numpy()
                for i, k in enumerate(draws["ssl_draws"]["keep_idx"])})
    out.update({f"metric/{k}": np.asarray(metrics[k]) for k in METRICS})
    out.update({f"grad/{k}": v for k, v in flat(grads)})
    out.update({f"param1/{k}": v for k, v in flat(params1)})
    np.savez_compressed(OUT_OBJECTIVES, **out)
    print(f"wrote {OUT_OBJECTIVES} ({OUT_OBJECTIVES.stat().st_size} bytes)")


# what the pre-tokenizer and the cleaning must get right: JAX's test
# captions, U+001C-U+001F (space to str.strip, not to regex's \s), the long
# s in contractions and specials, specials in capitals, html entities
# (unescaped twice), U+0345, combining marks, numbers of other scripts,
# Unicode spaces and separators, joiners, controls and private use
TOKEN_EDGE_CASES = [
    "a photo of a cat", "The Quick Brown Fox jumps over 123 lazy dogs!!",
    "hello   world,   with\tweird   whitespace",
    "émoji ünïcode tëst ¡hola!", "<|startoftext|>special tokens<|endoftext|>",
    "don't stop believing", "", "ISN'T she LOVELY (stevie wonder, 1976)",
    "we've they'll i'm you're it's won't can't",
    "3.14159 2,000,000 -42 1e-5 0xFF", "日本語のテキスト 中文文本 한국어",
    "emoji 😀 🚀 🧠 test", "'''quotes\"\"\" ``backticks`` «guillemets»",
    "https://example.com/path?query=1&x=2#frag",
    "\x1cfile\x1dgroup\x1erecord\x1funit\x1c", "a\x1c b \x1f",
    "  \x1f leading and trailing \x1c ", "the cat'ſ toy",
    "it'ſ <|ſtartoftext|> <|ENDOFTEXT|> <|EndOfText|>", "IT'S THE DOG'S",
    "!'s ?'ll ,'d ''re 'L 'LL",
    "&amp;amp; &lt;3 &#39;s &quot;quoted&quot; &nbsp;space",
    "\u0345 iota subscript \u03b1\u0345 \u1fb3",
    "e\u0301 combining acute, n\u0303",
    "numbers ٣٤ １２３ ² ½ Ⅻ ⑩ 𝟙",
    "tabs\tand\nnewlines\r\nand\x0bvertical\x0cfeed\x85nel",
    "\u2028line\u2029para\u200bzero\u200dwidth\ufeffbom\u3000ideo",
    "👨‍👩‍👧 family 🏳️‍🌈 flag",
    "ﬁ ligature ß straße ǅ titlecase", "İstanbul ıi Kelvin K",
    "control \x00 \x07 \x7f chars", "private \ue000 use",
    "rtl עברית العربية", "snake_case camelCase kebab-case",
    "antidisestablishmentarianism " * 3]
# (first, last) code points of the scripts seeded captions draw words from
TOKEN_SCRIPTS = [(0x00C0, 0x024F), (0x0370, 0x03FF), (0x0400, 0x04FF),
                 (0x0590, 0x06FF), (0x0900, 0x097F), (0x0E00, 0x0E7F),
                 (0x3040, 0x30FF), (0x4E00, 0x9FFF), (0xAC00, 0xD7A3),
                 (0x1F300, 0x1F64F), (0x2000, 0x206F), (0x2150, 0x218F),
                 (0x0300, 0x036F)]
TOKEN_WORDS = ("a photo of the cat dog on in with and two red blue green "
               "small large old young man woman child sitting standing "
               "beach city street mountain river painting drawing close up "
               "view people group table food car bike house tree sky night "
               "morning").split()
TOKEN_PUNCT = ["!", "?", "...", ",", ".", "'s", "'ll", "n't", "-", "(", ")",
               "\"", "&", "#", "@", "--", "!?"]
TOKEN_SEPS = [" "] * 30 + ["  ", "\t", "\n", "\u00a0", "\u3000", "\x1c"]
ASCII_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def token_captions(n=512):
    """TOKEN_EDGE_CASES, then seeded captions of 5-60 words: common words,
    random ASCII strings in either case, numbers, punctuation and
    contractions, and words of 1-6 code points from TOKEN_SCRIPTS (those
    Python's database assigns)."""
    import unicodedata
    npr = np.random.RandomState(SEED + 5)

    def word():
        kind = npr.rand()
        if kind < 0.5:
            w = TOKEN_WORDS[npr.randint(len(TOKEN_WORDS))]
            return w.capitalize() if npr.rand() < 0.1 else w
        if kind < 0.65:
            return "".join(ASCII_LETTERS[i] for i in npr.randint(
                52, size=npr.randint(2, 13)))
        if kind < 0.75:
            return str(npr.randint(0, 10 ** npr.randint(1, 7)))
        if kind < 0.85:
            return TOKEN_PUNCT[npr.randint(len(TOKEN_PUNCT))]
        lo, hi = TOKEN_SCRIPTS[npr.randint(len(TOKEN_SCRIPTS))]
        out, size = "", npr.randint(1, 7)
        while len(out) < size:
            c = chr(npr.randint(lo, hi + 1))
            if unicodedata.category(c) not in ("Cn", "Cs"):
                out += c
        return out

    out = list(TOKEN_EDGE_CASES)
    while len(out) < n:
        words = [word() for _ in range(npr.randint(5, 61))]
        out.append("".join(w + TOKEN_SEPS[npr.randint(len(TOKEN_SEPS))]
                           for w in words).strip(" "))
    return out


def write_tokens():
    from xclip_tpu.data.tokenizer import SimpleTokenizer
    tok = SimpleTokenizer(use_native=False)
    caps = [c.encode("utf-8") for c in token_captions()]
    ids = [tok.encode(c.decode("utf-8")) for c in caps]
    np.savez_compressed(
        OUT_TOKENS,
        caption_bytes=np.frombuffer(b"".join(caps), np.uint8),
        caption_offsets=np.cumsum([0] + [len(c) for c in caps]),
        ids=np.asarray([i for row in ids for i in row], np.int32),
        id_offsets=np.cumsum([0] + [len(r) for r in ids]))
    print(f"wrote {OUT_TOKENS} ({OUT_TOKENS.stat().st_size} bytes)")


def main():
    jax.config.update("jax_default_matmul_precision", "highest")
    if sys.argv[1:] == ["objectives"]:
        write_objectives()
        return
    if sys.argv[1:] == ["tokens"]:
        write_tokens()
        return
    npr = np.random.RandomState(SEED + 1)
    text = npr.randint(1, 100, (4, 16))
    for i in range(4):
        text[i, 16 - 4 * i:] = 0          # padded captions of mixed lengths
    images = npr.randn(4, 3, 32, 32).astype(np.float32)
    clip = xclip_tpu.CLIP(**CONFIG)
    params = jax.tree.map(jnp.asarray, numpy_params(CONFIG, SEED))
    npr = np.random.RandomState(SEED + 2)
    train_text = npr.randint(1, 100, (6, 16))
    for i in range(6):
        train_text[i, 16 - 2 * i:] = 0
    train_images = npr.randn(6, 3, 32, 32).astype(np.float32)
    lean_config = {**CONFIG, **LEAN_ROUTES}
    lean = train_step(xclip_tpu.CLIP(**lean_config), params, train_text,
                      train_images, prefix="lean_")
    np.savez_compressed(
        OUT, config=json.dumps(CONFIG), seed=SEED, text=text, images=images,
        **outputs(clip, params, text, images),
        lean_config=json.dumps(lean_config), **lean,
        **train_step(clip, params, train_text, train_images))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    write_rotary()
    write_ff()
    write_objectives()
    write_tokens()


if __name__ == "__main__":
    main()
