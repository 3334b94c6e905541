"""Tokenizers + incremental streaming decode — port of
``dynamo_tpu/tokenizer/base.py``.

``ByteTokenizer`` and ``DecodeStream`` are copies. In place of the JAX
package's ``HFTokenizer`` (``transformers`` is absent on the card's
machine), ``BPETokenizer`` reads a local byte-level BPE ``tokenizer.json``
(GPT-2 style: ByteLevel pre-tokenizer and decoder, BPE merges) and encodes
and decodes it in plain Python.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Protocol, Sequence


class BaseTokenizer(Protocol):
    bos_id: int | None
    eos_id: int
    vocab_size: int

    def encode(self, text: str, add_bos: bool = False) -> list[int]: ...
    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str: ...
    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True,
                            tools: list[dict] | None = None) -> str: ...


def _chatml(messages: list[dict], add_generation_prompt: bool = True,
            tools: list[dict] | None = None) -> str:
    """Minimal ChatML-style template (real models bring their own)."""
    parts = []
    if tools:
        parts.append(f"<|system|>\nAvailable tools: {json.dumps(tools)}\n")
    for m in messages:
        content = m.get("content") or ""
        if isinstance(content, list):
            content = "".join(p.get("text", "") for p in content if isinstance(p, dict))
        parts.append(f"<|{m.get('role', 'user')}|>\n{content}\n")
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids = byte + 4; specials pad=0 bos=1 eos=2 unk=3."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3
    OFFSET = 4

    def __init__(self, vocab_size: int = 512):
        self.bos_id: int | None = self.BOS
        self.eos_id = self.EOS
        self.pad_id = self.PAD
        self.vocab_size = max(vocab_size, 256 + self.OFFSET)

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        # ids beyond the byte range are vocab padding — they decode to nothing.
        return bytes(i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256)

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True,
                            tools: list[dict] | None = None) -> str:
        return _chatml(messages, add_generation_prompt, tools)


def _bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 bytes→unicode table of byte-level BPE vocabs: printable
    bytes map to themselves, the rest to a private range from U+0100."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# The GPT-2 pre-tokenizer split, with \p{L} as [^\W\d_] and \p{N} as \d
# (Python's re has no Unicode property classes).
_PRETOKENIZE = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""")


class BPETokenizer:
    """Byte-level BPE over a local ``tokenizer.json`` (encode + decode)."""

    def __init__(self, path: str | Path):
        path = Path(path)
        spec = json.loads((path / "tokenizer.json").read_text())
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"{path}: tokenizer model {model.get('type')!r} is "
                             "not byte-level BPE")
        self._vocab: dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        self._ranks = {pair: i for i, pair in enumerate(merges)}
        self._unk = self._vocab.get(model.get("unk_token") or "")
        self._specials = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self._special_ids = {t["id"] for t in spec.get("added_tokens", []) if t.get("special")}
        for content, idx in self._specials.items():
            self._vocab.setdefault(content, idx)
        self._id_to_tok = {i: t for t, i in self._vocab.items()}
        cfg_path = path / "tokenizer_config.json"
        cfg = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
        # As transformers loads a fast tokenizer: tokenizer_config.json's
        # add_prefix_space (default False) overrides the pre-tokenizer's.
        self._add_prefix_space = bool(cfg.get("add_prefix_space", False))
        self._enc = _bytes_to_unicode()
        self._dec = {c: b for b, c in self._enc.items()}
        self._split_specials = (re.compile("(" + "|".join(
            re.escape(s) for s in sorted(self._specials, key=len, reverse=True)) + ")")
            if self._specials else None)

        def special(name: str) -> int | None:
            tok = cfg.get(name)
            if isinstance(tok, dict):
                tok = tok.get("content")
            return self._vocab.get(tok) if tok else None

        self.bos_id = special("bos_token")
        eos = special("eos_token")
        self.eos_id = eos if eos is not None else 0
        self.vocab_size = max(self._id_to_tok) + 1

    def _bpe(self, piece: str) -> list[int]:
        word = [self._enc[b] for b in piece.encode("utf-8")]
        no_merge = len(self._ranks)
        while len(word) > 1:
            # Merge every occurrence of the lowest-ranked adjacent pair.
            first, second = min(zip(word, word[1:]),
                                key=lambda p: self._ranks.get(p, no_merge))
            if (first, second) not in self._ranks:
                break
            merged, j = [], 0
            while j < len(word):
                if j < len(word) - 1 and word[j] == first and word[j + 1] == second:
                    merged.append(first + second)
                    j += 2
                else:
                    merged.append(word[j])
                    j += 1
            word = merged
        ids = []
        for sym in word:
            idx = self._vocab.get(sym, self._unk)
            if idx is None:
                raise ValueError(f"symbol {sym!r} is not in the vocab and there is no unk token")
            ids.append(idx)
        return ids

    def encode(self, text: str, add_bos: bool = False) -> list[int]:
        ids: list[int] = []
        parts = self._split_specials.split(text) if self._split_specials else [text]
        first = True
        for part in parts:
            if not part:
                continue
            if part in self._specials:
                ids.append(self._specials[part])
                continue
            if first and self._add_prefix_space and not part.startswith(" "):
                part = " " + part
            first = False
            for piece in _PRETOKENIZE.findall(part):
                ids.extend(self._bpe(piece))
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        out = bytearray()
        for i in ids:
            if i in self._special_ids:
                if not skip_special:
                    out += self._id_to_tok[i].encode("utf-8")
                continue
            tok = self._id_to_tok.get(int(i))
            if tok is None:
                continue
            out += bytes(self._dec[c] for c in tok if c in self._dec)
        return out.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: list[dict], add_generation_prompt: bool = True,
                            tools: list[dict] | None = None) -> str:
        return _chatml(messages, add_generation_prompt, tools)


_SP_BYTE_RE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")


def guided_vocab(tok: ByteTokenizer | BPETokenizer, size: int | None = None) -> list[str]:
    """Token-id → text table for constrained decoding (engine/guided.py) —
    the JAX package's ``guided_vocab`` for this package's two tokenizers.

    Built from the tokenizer's own vocab in one pass instead of V per-id
    decodes: byte-level BPE pieces are mapped through the GPT-2 byte
    decoder (exact text, leading-space markers included), sentencepiece
    pieces get their ▁ marker substituted (``<0xHH>`` byte-fallback pieces:
    an ASCII byte becomes its character, a non-ASCII byte — a partial UTF-8
    sequence — stays "" so the masker never matches half a codepoint), and
    special tokens decode to "" so the masker never trial-feeds control
    markup. ``size`` pads with "" (or truncates) to the MODEL vocab."""
    if isinstance(tok, ByteTokenizer):
        v = size or tok.vocab_size
        pieces = [""] * v
        for i in range(tok.OFFSET, min(tok.OFFSET + 256, v)):
            pieces[i] = bytes([i - tok.OFFSET]).decode("utf-8", errors="replace")
        return pieces
    v = size or tok.vocab_size
    pieces = [""] * v
    for piece, idx in tok._vocab.items():
        if not (0 <= idx < v) or idx in tok._special_ids:
            continue
        m = _SP_BYTE_RE.match(piece)
        if m is not None:
            b = int(m.group(1), 16)
            pieces[idx] = chr(b) if b < 0x80 else ""
        elif all(ch in tok._dec for ch in piece):
            pieces[idx] = bytes(tok._dec[ch] for ch in piece).decode("utf-8", errors="replace")
        else:
            pieces[idx] = piece.replace("▁", " ")
    return pieces


def load_tokenizer(name_or_path: str | None) -> BaseTokenizer:
    """A local dir with ``tokenizer.json`` → its byte-level BPE; anything
    else → the built-in byte tokenizer."""
    if name_or_path and (Path(name_or_path) / "tokenizer.json").exists():
        return BPETokenizer(name_or_path)
    return ByteTokenizer()


class DecodeStream:
    """Incremental detokenizer for one response stream.

    Decode a *segment* of recent token ids and emit the text grown since
    the last emission. Emission is withheld while the segment's decode ends
    in U+FFFD (incomplete multi-byte sequence split across tokens). The
    segment is compacted at whitespace boundaries so cost stays
    O(segment), not O(stream).
    """

    _COMPACT_AFTER = 48  # tokens

    def __init__(self, tokenizer: BaseTokenizer, skip_special: bool = True):
        self._tok = tokenizer
        self._skip_special = skip_special
        self._seg_ids: list[int] = []
        self._seg_emitted = 0  # chars of decode(_seg_ids) already emitted

    def step(self, token_id: int) -> str:
        """Feed one token; return the new text to emit ("" if withheld)."""
        self._seg_ids.append(token_id)
        text = self._tok.decode(self._seg_ids, skip_special=self._skip_special)
        if text.endswith("�"):
            return ""  # incomplete multi-byte sequence — wait for more tokens
        delta = text[self._seg_emitted :]
        self._seg_emitted = len(text)
        if len(self._seg_ids) >= self._COMPACT_AFTER and delta[-1:].isspace():
            self._seg_ids.clear()
            self._seg_emitted = 0
        return delta

    def flush(self) -> str:
        """Emit any withheld tail at stream end."""
        if not self._seg_ids:
            return ""
        text = self._tok.decode(self._seg_ids, skip_special=self._skip_special)
        delta = text[self._seg_emitted :]
        self._seg_ids.clear()
        self._seg_emitted = 0
        return delta
