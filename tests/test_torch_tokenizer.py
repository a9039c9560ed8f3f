"""The port's tokenizer (`xclip_tpu_torch.data.tokenizer`, the native merge
loop `xclip_tpu_torch.native.fast_bpe`) against JAX's `SimpleTokenizer` on
the CPU, ids compared exactly.

The port pre-tokenizes with Python's `re` and classes spelled out from
`unicodedata`, where JAX uses `regex`: the two are held equal on every code
point Python's database assigns (not Cn, not Cs), alone and inside ASCII
context, and on U+001C-U+001F, which `str.strip` takes as whitespace and
`regex`'s `\\s` does not. `encode`, `decode` and `tokenize` are compared
through the Python and the native merge loops, on JAX's test captions, the
committed golden captions (`tests/data/torch_port_golden_tokens.npz`,
written by `tests/make_torch_port_golden.py tokens`; phase 25 of
`chip_smoke.py` holds the port on the GPU to the same file) and 200
hypothesis strings.
"""

import hashlib
import importlib
import json
import os
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from xclip_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from xclip_tpu_torch.data.tokenizer import SimpleTokenizer
from xclip_tpu_torch.native import fast_bpe
import torch_one_thread  # noqa: F401

JT = importlib.import_module("xclip_tpu.data.tokenizer")
PT = importlib.import_module("xclip_tpu_torch.data.tokenizer")
ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden_tokens.npz"

SAMPLES = [
    "a photo of a cat",
    "The Quick Brown Fox jumps over 123 lazy dogs!!",
    "hello   world,   with\tweird   whitespace",
    "émoji ünïcode tëst ¡hola!",
    "<|startoftext|>special tokens<|endoftext|>",
    "don't stop believing",
    "",
    "antidisestablishmentarianism 12345 !!!",
    "ünïcode wörds ünïcode",
]
# U+001C-U+001F: whitespace to str.strip (so stripped at the ends, as
# JAX's .strip() calls do), not to regex's \s (kept inside the text)
SEPARATORS = ["\x1ca photo\x1d of\x1e a cat\x1f", "a\x1cb", " \x1f x \x1c ",
              "\x1c\x1d\x1e\x1f", "it\x1c's \x1f'll"]


@pytest.fixture(scope="module")
def jax_tok():
    return JaxTokenizer(use_native=False)


@pytest.fixture(scope="module", params=["native", "python"])
def port_tok(request):
    tok = SimpleTokenizer(use_native=request.param == "native")
    assert (tok._native is not None) == (request.param == "native")
    return tok


def golden_captions():
    g = np.load(GOLDEN)
    cb, co, ids, io = (g["caption_bytes"], g["caption_offsets"], g["ids"],
                       g["id_offsets"])
    return [(bytes(cb[co[i]:co[i + 1]]).decode("utf-8"),
             ids[io[i]:io[i + 1]].tolist()) for i in range(len(co) - 1)]


def test_vocabulary_is_a_byte_identical_copy():
    def sha(p):
        return hashlib.sha256(Path(p).read_bytes()).hexdigest()
    assert sha(PT.default_bpe()) == sha(JT.default_bpe())
    assert Path(PT.default_bpe()).parent == ROOT / "xclip_tpu_torch" / "data"


@pytest.mark.parametrize("context", ["{} ", "a{}b'{}s1{}!{}<|endoftext|>"])
def test_scanner_matches_regex_on_every_assigned_code_point(jax_tok,
                                                            context):
    cps = [cp for cp in range(0x110000)
           if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]
    ours = PT.pretokenizer()

    def fill(cp):
        return context.replace("{}", chr(cp))

    wrong = []
    for i in range(0, len(cps), 4096):
        chunk = cps[i:i + 4096]
        text = "".join(map(fill, chunk))
        if ours.findall(text) != jax_tok.pat.findall(text):
            wrong += [hex(c) for c in chunk if ours.findall(fill(c))
                      != jax_tok.pat.findall(fill(c))]
    assert not wrong


@pytest.mark.parametrize("separators", ["with", "without"])
def test_whitespace_clean_matches_on_every_assigned_code_point(separators):
    """With U+001C-U+001F in the text and without them."""
    text = "".join(chr(cp) + "a" for cp in range(0x110000)
                   if unicodedata.category(chr(cp)) not in ("Cn", "Cs"))
    if separators == "without":
        text = text.translate(dict.fromkeys(range(0x1c, 0x20)))
    for t in (text, text[::-1], "  " + text + "\t\u3000"):
        assert PT._whitespace_clean(t) == JT._whitespace_clean(t)


@pytest.mark.parametrize("text", SEPARATORS)
def test_separators_1c_to_1f_match_jax(jax_tok, port_tok, text):
    assert PT._whitespace_clean(text) == JT._whitespace_clean(text)
    assert PT._basic_clean(text) == JT._basic_clean(text)
    assert port_tok.pat.findall(text) == jax_tok.pat.findall(text)
    assert port_tok.encode(text) == jax_tok.encode(text)


def test_encode_decode_tokenize_match_jax(jax_tok, port_tok):
    texts = SAMPLES + [c for c, _ in golden_captions()[:64]]
    for text in texts:
        ids = port_tok.encode(text)
        assert ids == jax_tok.encode(text), text
        assert all(type(i) is int for i in ids)
        assert port_tok.decode(ids) == jax_tok.decode(ids)
        wrapped = [49406, *ids, 49407, 0, 0]
        assert port_tok.decode(wrapped) == jax_tok.decode(wrapped)
        assert (port_tok.decode(wrapped, remove_start_end=False,
                                pad_tokens=(0,))
                == jax_tok.decode(wrapped, remove_start_end=False,
                                  pad_tokens=(0,)))
    for kw in (dict(context_length=256),
               dict(context_length=8, truncate_text=True),
               dict(context_length=200, pad_to_context_length=True)):
        got, want = port_tok.tokenize(texts, **kw), jax_tok.tokenize(texts, **kw)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert (port_tok.vocab_size, port_tok.sot_token, port_tok.eot_token) \
        == (jax_tok.vocab_size, jax_tok.sot_token, jax_tok.eot_token)


def test_golden_ids_are_jax_ids_and_the_port_s(jax_tok, port_tok):
    """The committed file is JAX's tokenizer's output (it cannot drift), and
    the port gives the same ids through both merge loops."""
    for text, ids in golden_captions():
        assert jax_tok.encode(text) == ids, text
        assert port_tok.encode(text) == ids, text


ASSIGNED = st.characters(exclude_categories=("Cn", "Cs"))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.text(ASSIGNED, max_size=60)
       | st.lists(st.sampled_from(["a", "'s", "'LL", "ſ", "\x1c", " ", "<|",
                                   "endoftext", "|>", "1", "!", "\u0345",
                                   "é", "&amp;", "日本", "\t"]),
                  max_size=30).map("".join))
def test_hypothesis_strings_match_jax(text):
    want = _tokenizers()[0].encode(text)
    for tok in _tokenizers()[1:]:
        assert tok.encode(text) == want
        assert tok.decode(want) == _tokenizers()[0].decode(want)


_TOKENIZERS = []


def _tokenizers():
    """JAX's Python loop, the port's native and Python loops (hypothesis
    takes no function-scoped fixtures)."""
    if not _TOKENIZERS:
        _TOKENIZERS.extend([JaxTokenizer(use_native=False), SimpleTokenizer(),
                            SimpleTokenizer(use_native=False)])
    return _TOKENIZERS


@pytest.mark.parametrize("texts,kw", [
    (123, {}), (["a cat", 7], {}), ([b"a cat"], {}), (("a", None, 2.0), {}),
    ("a photo of a cat", dict(context_length=3))])
def test_errors_match_jax(jax_tok, port_tok, texts, kw):
    with pytest.raises((TypeError, RuntimeError)) as want:
        jax_tok.tokenize(texts, **kw)
    with pytest.raises(want.type) as got:
        port_tok.tokenize(texts, **kw)
    assert str(got.value) == str(want.value)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a compiler that fails or is missing makes the native
    tokenizer raise, with the compiler's words."""
    broken = tmp_path / "cxx"
    broken.write_text("#!/bin/sh\necho no-such-header.h: not found >&2\n"
                      "exit 3\n")
    broken.chmod(0o755)
    monkeypatch.setenv("CXX", str(broken))
    with pytest.raises(RuntimeError, match="no-such-header.h: not found"):
        fast_bpe.build(tmp_path)
    assert list(tmp_path.glob("*.so")) == []
    monkeypatch.setenv("CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(RuntimeError, match="could not run"):
        fast_bpe.build(tmp_path)
    monkeypatch.setattr(fast_bpe, "BUILD_DIR", tmp_path)
    fast_bpe.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="missing-g\\+\\+"):
            SimpleTokenizer(use_native=True)
        assert SimpleTokenizer(use_native=False).encode("a cat") == [320,
                                                                    2368]
    finally:
        fast_bpe.library.cache_clear()


def test_native_library_builds_outside_the_package():
    lib = fast_bpe.build()
    assert lib.parent == ROOT / "build" / "xclip_tpu_torch"
    assert lib.name.startswith("libfastbpe_") and lib.exists()
    assert not list((ROOT / "xclip_tpu_torch").rglob("*.so"))


_CHILD = """
import json, subprocess, sys
sys.modules["regex"] = None          # `import regex` raises ImportError
real_popen = subprocess.Popen
def refuse(*args, **kwargs):
    raise AssertionError(f"import ran {args}")
subprocess.Popen = refuse
import xclip_tpu_torch.data as data
from xclip_tpu_torch.native import fast_bpe
module = sys.modules["xclip_tpu_torch.data.tokenizer"]
report = {"imported": sorted(m for m in ("jax", "xclip_tpu", "regex", "PIL")
                             if sys.modules.get(m) is not None),
          "libraries": fast_bpe.library.cache_info().currsize,
          "shared": module._shared.cache_info().currsize}
subprocess.Popen = real_popen
texts = json.loads(sys.argv[1])
report["native"] = [data.SimpleTokenizer().encode(t) for t in texts]
report["python"] = [data.SimpleTokenizer(use_native=False).encode(t)
                    for t in texts]
report["shared_ids"] = data.tokenizer.encode(texts[0])
report["shared_type"] = type(data.tokenizer).__name__
print(json.dumps(report))
"""


def test_import_builds_nothing_and_needs_no_regex(jax_tok):
    texts = SAMPLES + SEPARATORS
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(texts)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["imported"] == []
    assert report["libraries"] == 0 and report["shared"] == 0
    want = [jax_tok.encode(t) for t in texts]
    assert report["native"] == want and report["python"] == want
    assert report["shared_ids"] == want[0]
    assert report["shared_type"] == "SimpleTokenizer"
