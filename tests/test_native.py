"""Native library tests: conversions, PNG, tokenizer C++/Python parity."""

import json
import zlib

import numpy as np
import pytest

from stabletriton_jax import native
from stabletriton_jax.io.tokenizer import CLIPTokenizer, PyCLIPTokenizer


def test_native_lib_builds_and_loads():
    assert native.have_native(), "native library must build in this environment"


def test_bf16_and_f16_widening():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(1000).astype(np.float32)
    bf16_raw = (vals.view(np.uint32) >> 16).astype(np.uint16)
    widened = native.bf16_to_f32(bf16_raw)
    expected = (bf16_raw.astype(np.uint32) << 16).view(np.float32)
    np.testing.assert_array_equal(widened, expected)

    f16 = vals.astype(np.float16)
    widened16 = native.f16_to_f32(f16.view(np.uint16))
    np.testing.assert_array_equal(widened16, f16.astype(np.float32))
    # subnormals + inf + nan
    specials = np.array([6e-8, -6e-8, np.inf, -np.inf, np.nan, 0.0, -0.0], np.float16)
    w = native.f16_to_f32(specials.view(np.uint16))
    np.testing.assert_array_equal(
        np.isnan(w), np.isnan(specials.astype(np.float32))
    )
    np.testing.assert_array_equal(w[~np.isnan(w)], specials.astype(np.float32)[~np.isnan(specials)])


def test_transposes_match_numpy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 53)).astype(np.float32)
    np.testing.assert_array_equal(native.transpose_2d(x), x.T)
    c = rng.standard_normal((5, 3, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(native.oihw_to_hwio(c), c.transpose(2, 3, 1, 0))


def test_rgb8_and_png_roundtrip():
    rng = np.random.default_rng(2)
    img = rng.uniform(-1.2, 1.2, (13, 17, 3)).astype(np.float32)
    rgb = native.to_rgb8(img)
    expected = np.clip((img + 1) * 127.5 + 0.5, 0, 255).astype(np.uint8)
    assert np.abs(rgb.astype(int) - expected.astype(int)).max() <= 1  # rounding edge
    png = native.encode_png(rgb)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    # decode IDAT manually and verify pixels survive
    pos, payload = 8, b""
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        typ = png[pos + 4:pos + 8]
        if typ == b"IDAT":
            payload += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(payload)
    h, w, _ = rgb.shape
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3), rgb)
    # python fallback must byte-match the native encoder's pixels
    py_png = native._encode_png_py(rgb)
    assert py_png[:8] == png[:8]


@pytest.fixture(scope="module")
def toy_tok(tmp_path_factory):
    """Toy BPE: vocab of single chars + a few merges."""
    d = tmp_path_factory.mktemp("tok")
    enc = {}
    # single-symbol tokens for printable ascii, with and without </w>
    tid = 0
    vocab = {}
    for b in range(ord(" "), 127):
        vocab[chr(b)] = tid; tid += 1
        vocab[chr(b) + "</w>"] = tid; tid += 1
    for extra in ["he", "llo", "hello</w>", "lo", "lo</w>", "llo</w>", "he</w>"]:
        vocab[extra] = tid; tid += 1
    vocab["<|startoftext|>"] = tid; tid += 1
    vocab["<|endoftext|>"] = tid; tid += 1
    # BPE path for "hello": [h e l l o</w>] -> [he l l o</w>] -> [he l lo</w>]
    # -> [he llo</w>] -> [hello</w>]
    merges = ["#version: 0.2", "h e", "l o</w>", "l lo</w>", "he llo</w>"]
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("\n".join(merges))
    return d / "vocab.json", d / "merges.txt", vocab


def test_py_tokenizer_bpe(toy_tok):
    vp, mp, vocab = toy_tok
    tok = PyCLIPTokenizer(vp, mp)
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    ids = tok.encode("Hello  hello", max_len=8, bos=bos, eos=eos, pad=0)
    # "hello" -> h e l l o -> he l lo</w> -> he llo</w> -> hello</w>
    assert list(ids[:4]) == [bos, vocab["hello</w>"], vocab["hello</w>"], eos]
    assert list(ids[4:]) == [0, 0, 0, 0]


def test_native_tokenizer_matches_python(toy_tok):
    vp, mp, vocab = toy_tok
    tok = CLIPTokenizer(vp, mp)
    assert tok.backend == "native"
    py = PyCLIPTokenizer(vp, mp)
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    for text in ["hello", "Hello, World!  123", "it's a test's", "", "   ",
                 "héllo naïve", "a" * 300]:
        a = tok.encode(text, max_len=16, bos=bos, eos=eos, pad=0)
        b = py.encode(text, max_len=16, bos=bos, eos=eos, pad=0)
        np.testing.assert_array_equal(a, b, err_msg=repr(text))


def test_tokenizer_truncation(toy_tok):
    vp, mp, vocab = toy_tok
    tok = CLIPTokenizer(vp, mp)
    ids = tok.encode("x y z w v u t s", max_len=5, bos=1, eos=2, pad=0)
    assert ids.shape == (5,)
    assert ids[0] == 1 and ids[-1] == 2


def test_tokenizer_encode_windows(toy_tok):
    vp, mp, vocab = toy_tok
    tok = CLIPTokenizer(vp, mp)
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    # 10 single-char words -> 10 tokens; window payload is max_len-2 = 6
    out = tok.encode_windows("a b c d e f g h i j", max_len=8, bos=bos, eos=eos, pad=0)
    assert out.shape == (16,)  # 2 windows of 8
    assert out[0] == bos and out[8] == bos
    assert out[7] == eos and list(out[13:15]) == [0, 0] or out[-1] in (0, eos)
    # fixed window count pads out
    out3 = tok.encode_windows("a b", windows=3, max_len=8, bos=bos, eos=eos, pad=0)
    assert out3.shape == (24,)
    assert out3[16] == bos  # third window exists, empty payload
