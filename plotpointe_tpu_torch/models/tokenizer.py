"""WordPiece tokenizer for the MiniLM text tower.

A copy of `plotpointe_tpu/models/tokenizer.py` (pure Python; the port
imports nothing of the JAX package): a BERT-style basic tokenizer
(lowercase, accent strip, punctuation/CJK split) plus greedy
longest-match-first WordPiece against a local `vocab.txt`. For the same
vocab and text it gives the JAX package's ids and mask. With the converted
MiniLM weights (`tools/convert_weights.py`) it reproduces the reference's
real text embeddings without any network or transformers dependency.
"""
from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Iterable, List, Tuple

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even when unicodedata does not
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab file."""

    def __init__(
        self,
        vocab: Iterable[str] | str | Path,
        lowercase: bool = True,
        max_chars_per_word: int = 100,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
    ):
        if isinstance(vocab, (str, Path)):
            vocab = Path(vocab).read_text(encoding="utf-8").splitlines()
        self.vocab = {tok: i for i, tok in enumerate(v.rstrip("\n") for v in vocab)}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.unk_id = self.vocab[unk_token]
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.pad_id = self.vocab[pad_token]

    # -- basic tokenization (BERT BasicTokenizer semantics) -------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) == "Cc" and ch not in "\t\n\r":
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif ch in "\t\n\r" or unicodedata.category(ch) == "Zs":
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    def _split_word(self, word: str) -> List[str]:
        if self.lowercase:
            word = word.lower()
            word = "".join(c for c in unicodedata.normalize("NFD", word)
                           if unicodedata.category(c) != "Mn")
        pieces, cur = [], []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    # -- wordpiece -------------------------------------------------------------

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece_id = self.vocab[sub]
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def tokenize_ids(self, text: str) -> List[int]:
        ids: List[int] = []
        for raw in self._clean(text or "").split():
            for word in self._split_word(raw):
                ids.extend(self._wordpiece(word))
        return ids

    def encode(self, texts: List[str], max_len: int = 256) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] ids [SEP], padded/truncated -> (token_ids [B,S] int32, mask [B,S] f32)."""
        token_ids = np.full((len(texts), max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), max_len), np.float32)
        for r, t in enumerate(texts):
            ids = [self.cls_id] + self.tokenize_ids(t)[: max_len - 2] + [self.sep_id]
            token_ids[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1.0
        return token_ids, mask
