"""Offline BERT WordPiece tokenizer.

The reference uses HuggingFace ``BertTokenizer.from_pretrained`` at runtime
(``utils/dataset/dataset_init.py:97``).  This image has no network egress, so
we provide a self-contained WordPiece implementation that (a) loads any
``vocab.txt`` (including the real bert-base-uncased vocab when present on
disk or in the HF cache), and (b) matches HF's basic+wordpiece pipeline for
the lowercased/uncased configuration.

``load_tokenizer(name_or_path)`` resolution order:
  1. a local path to a vocab.txt / directory containing one
  2. the HF cache (offline mode)
  3. raises with a clear message (callers in tests pass fixture vocabs)
"""
from __future__ import annotations

import os
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Union

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    """HF BasicTokenizer._is_chinese_char ranges (CJK ideographs only —
    not Hangul/Katakana, which segment by spaces/wordpiece instead)."""
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """HF-compatible uncased basic + WordPiece tokenization."""

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.do_lower_case = do_lower_case
        self._max_chars = max_chars_per_word
        self.unk_token = "[UNK]"
        # HF never-splits ONLY the five special tokens — other bracketed
        # vocab entries ([unused0]...) split like ordinary text
        # ('[', 'unused', '##0', ']'), so treating them as atomic would
        # diverge from the reference tokenizer on any text containing one
        self._special = {t for t in SPECIAL_TOKENS if t in vocab}

    # ------------------------------------------------------------------ #
    @classmethod
    def from_vocab_file(cls, path: Union[str, Path], **kw):
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    # ------------------------------------------------------------------ #
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        if any(_is_cjk(ord(ch)) for ch in text):
            # HF space-isolates every CJK ideograph before splitting, so
            # a CJK run glued to latin text ('走left') tokenizes to
            # ['走', 'left'], not one [UNK] word
            text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch
                           for ch in text)
        if self.do_lower_case:
            text = text.lower()
            text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                           if unicodedata.category(ch) != "Mn")
        tokens: List[str] = []
        word: List[str] = []
        for ch in text:
            if _is_whitespace(ch):
                if word:
                    tokens.append("".join(word))
                    word = []
            elif _is_punctuation(ch):
                if word:
                    tokens.append("".join(word))
                    word = []
                tokens.append(ch)
            else:
                word.append(ch)
        if word:
            tokens.append("".join(word))
        return tokens

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self._max_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    # ------------------------------------------------------------------ #
    def _split_on_specials(self, text: str) -> List[str]:
        """Split text into [plain, special, plain, ...] chunks."""
        if not self._special or "[" not in text:
            return [text]
        import re
        pattern = "(" + "|".join(re.escape(t) for t in self._special) + ")"
        return [c for c in re.split(pattern, text) if c]

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in self._split_on_specials(text):
            if chunk in self._special:
                out.append(chunk)
                continue
            for word in self._basic_tokenize(chunk):
                out.extend(self._wordpiece(word))
        return out

    def convert_tokens_to_ids(self, tokens) -> Union[int, List[int]]:
        unk = self.vocab[self.unk_token]
        if isinstance(tokens, str):
            return self.vocab.get(tokens, unk)
        return [self.vocab.get(t, unk) for t in tokens]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    def __len__(self):
        return len(self.vocab)


def _hf_cached_vocab(name: str) -> Optional[Path]:
    hub = Path(os.environ.get("HF_HOME",
                              Path.home() / ".cache" / "huggingface")) / "hub"
    if not hub.exists():
        return None
    for d in hub.glob(f"models--{name.replace('/', '--')}/snapshots/*/"):
        v = d / "vocab.txt"
        if v.exists():
            return v
    return None


def load_tokenizer(name_or_path: Union[str, Path]) -> WordPieceTokenizer:
    p = Path(name_or_path)
    if p.is_file():
        return WordPieceTokenizer.from_vocab_file(p)
    if p.is_dir() and (p / "vocab.txt").exists():
        return WordPieceTokenizer.from_vocab_file(p / "vocab.txt")
    cached = _hf_cached_vocab(str(name_or_path))
    if cached is not None:
        return WordPieceTokenizer.from_vocab_file(cached)
    raise FileNotFoundError(
        f"No vocab found for '{name_or_path}'. Provide a vocab.txt path "
        "(network access is unavailable).")


def write_vocab(tokens: List[str], path: Union[str, Path]) -> None:
    """Helper for fixtures: write a vocab file with the BERT special-token
    ids preserved when possible ([PAD]=0)."""
    with open(path, "w", encoding="utf-8") as f:
        for t in tokens:
            f.write(t + "\n")
