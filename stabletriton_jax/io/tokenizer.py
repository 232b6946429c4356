"""CLIP BPE tokenizer: native (C++) fast path + pure-Python reference.

Given a checkpoint's ``vocab.json`` + ``merges.txt`` (the files every SDXL
distribution ships for both text encoders), encodes prompts to the fixed
77-token frames the encoders consume. The Python implementation is the
behavioral reference; the C++ one (native/src/tokenizer.cpp, via ctypes) is
used when available and is parity-tested against it.

SDXL framing defaults: bos 49406, eos 49407; encoder 1 pads with eos,
encoder 2 (OpenCLIP bigG) pads with 0.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

from stabletriton_jax import native


@functools.cache
def _byte_encoder() -> dict[int, str]:
    """GPT-2/CLIP bytes->unicode: visible latin-1 map to themselves, rest to
    256+n in order."""
    direct = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    mapping = {}
    next_cp = 256
    for b in range(256):
        if b in direct:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(next_cp)
            next_cp += 1
    return mapping


class PyCLIPTokenizer:
    """Reference implementation of the CLIP byte-level BPE."""

    def __init__(self, vocab_path: str | Path, merges_path: str | Path):
        self.vocab: dict[str, int] = json.loads(Path(vocab_path).read_text())
        ranks: dict[tuple[str, str], int] = {}
        for i, line in enumerate(Path(merges_path).read_text().splitlines()):
            if not line or line.startswith("#"):
                continue
            a, _, b = line.partition(" ")
            ranks[(a, b)] = len(ranks)
        self.ranks = ranks
        self.unk = self.vocab.get("<|endoftext|>", 0)

    def _bpe(self, symbols: list[str]) -> list[str]:
        while len(symbols) > 1:
            best, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self.ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best is None or r < best):
                    best, best_i = r, i
            if best is None:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return symbols

    def _encode_word(self, word: str) -> list[int]:
        enc = _byte_encoder()
        symbols = [enc[b] for b in word.encode("utf-8")]
        if not symbols:
            return []
        symbols[-1] += "</w>"
        return [self.vocab.get(s, self.unk) for s in self._bpe(symbols)]

    @staticmethod
    def _pretokenize(text: str):
        """ASCII approximation of the CLIP regex (same as the native impl)."""
        t = " ".join(text.split()).lower()
        contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
        is_letter = lambda c: c.isascii() and c.isalpha() or ord(c) >= 0x80
        is_digit = lambda c: c.isascii() and c.isdigit()
        i, out = 0, []
        while i < len(t):
            c = t[i]
            if c == " ":
                i += 1
                continue
            if c == "'":
                matched = next((cs for cs in contractions if t.startswith(cs, i)), None)
                if matched:
                    out.append(matched)
                    i += len(matched)
                    continue
            j = i
            if is_letter(c):
                while j < len(t) and is_letter(t[j]):
                    j += 1
            elif is_digit(c):
                j = i + 1
            else:
                while j < len(t) and t[j] != " " and not is_letter(t[j]) and not is_digit(t[j]):
                    j += 1
            out.append(t[i:j])
            i = j
        return out

    def encode(self, text: str, *, max_len: int = 77, bos: int = 49406,
               eos: int = 49407, pad: int = 49407) -> np.ndarray:
        ids = [bos]
        for word in self._pretokenize(text):
            ids.extend(self._encode_word(word))
        ids = ids[: max_len - 1] + [eos]
        ids += [pad] * (max_len - len(ids))
        return np.asarray(ids, np.int32)


class CLIPTokenizer:
    """Public tokenizer: native-backed when the .so is available."""

    def __init__(self, vocab_path: str | Path, merges_path: str | Path):
        self._py = PyCLIPTokenizer(vocab_path, merges_path)
        self._handle = None
        l = native.lib()
        if l is not None:
            h = l.st_tok_create(str(vocab_path).encode(), str(merges_path).encode())
            if h:
                self._handle = h
                self._lib = l

    @property
    def backend(self) -> str:
        return "native" if self._handle else "python"

    def encode(self, text: str, *, max_len: int = 77, bos: int = 49406,
               eos: int = 49407, pad: int = 49407) -> np.ndarray:
        if self._handle:
            out = np.empty(max_len, np.int32)
            n = self._lib.st_tok_encode(
                self._handle, text.encode("utf-8"), out.ctypes.data,
                max_len, bos, eos, pad,
            )
            if n >= 0:
                return out
        return self._py.encode(text, max_len=max_len, bos=bos, eos=eos, pad=pad)

    def encode_batch(self, texts: list[str], **kw) -> np.ndarray:
        return np.stack([self.encode(t, **kw) for t in texts])

    def encode_windows(
        self, text: str, *, windows: int | None = None, max_len: int = 77,
        bos: int = 49406, eos: int = 49407, pad: int = 49407,
    ) -> np.ndarray:
        """Long-prompt encoding: split into (max_len-2)-token windows, each
        framed with bos/eos (the A1111 convention the pipeline's chunked
        encoder consumes). Returns (windows * max_len,) ids; ``windows=None``
        uses as many as the prompt needs (minimum 1)."""
        per = max_len - 2
        ids: list[int] = []
        for word in self._py._pretokenize(text):
            ids.extend(self._py._encode_word(word))
        k = windows or max(1, -(-len(ids) // per))
        rows = []
        for i in range(k):
            chunk = ids[i * per:(i + 1) * per]
            row = [bos] + chunk + [eos] + [pad] * (per - len(chunk))
            rows.append(np.asarray(row, np.int32))
        return np.concatenate(rows)

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.st_tok_free(h)
            self._handle = None


def sdxl_tokenize(tok1: CLIPTokenizer, tok2: CLIPTokenizer, prompts: list[str]):
    """(ids1, ids2) with SDXL's per-encoder padding conventions."""
    ids1 = tok1.encode_batch(prompts, pad=49407)
    ids2 = tok2.encode_batch(prompts, pad=0)
    return ids1, ids2
