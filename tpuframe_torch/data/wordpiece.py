"""WordPiece tokenizer (counterpart of ``tpuframe/data/wordpiece.py``).

BERT's "basic" pre-tokenization (lowercase and accent strip for uncased
vocabs, punctuation splitting, CJK isolation) followed by greedy
longest-match-first WordPiece with ``##`` continuation pieces, driven by
a standard ``vocab.txt`` (one token per line).  The same algorithm as the
JAX package's, which matches ``transformers.BertTokenizer`` token for
token; this copy needs neither.  The vocab is read from a local path:
``gs://`` raises, as the port's datasets do.
"""

from __future__ import annotations

import unicodedata

import numpy as np

_PAD, _UNK, _CLS, _SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even where unicode doesn't
    # (e.g. ``$``, ``^``, backtick).
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


class WordPieceTokenizer:
    """Vocab-file-driven BERT tokenizer.

    ``vocab`` may be a local path to a ``vocab.txt`` or an
    already-built ``{token: id}`` dict.  ``lowercase=True`` matches the
    ``bert-base-uncased`` convention the reference's GLUE recipe uses.
    """

    def __init__(self, vocab: str | dict, *, lowercase: bool = True,
                 max_chars_per_word: int = 100):
        if isinstance(vocab, str):
            if "://" in vocab:
                raise NotImplementedError(
                    f"{vocab!r}: only local vocab files are ported (the GCS"
                    f" reader is ROADMAP.md queue 1, item 4)")
            with open(vocab, "rb") as f:
                lines = f.read().decode("utf-8").split("\n")
            if lines and lines[-1] == "":
                lines.pop()
            self.vocab = {tok: i for i, tok in enumerate(lines)}
        else:
            self.vocab = dict(vocab)
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        for tok in (_PAD, _UNK, _CLS, _SEP):
            if tok not in self.vocab:
                raise ValueError(f"vocab is missing required token {tok!r}")
        self.pad_id = self.vocab[_PAD]
        self.unk_id = self.vocab[_UNK]
        self.cls_id = self.vocab[_CLS]
        self.sep_id = self.vocab[_SEP]

    # -- basic tokenization (BERT's pre-split) ------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif unicodedata.category(ch) == "Zs" or ch in ("\t", "\n", "\r"):
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)

    def _split_word(self, word: str) -> list[str]:
        if self.lowercase:
            word = word.lower()
            word = "".join(ch for ch in unicodedata.normalize("NFD", word)
                           if unicodedata.category(ch) != "Mn")
        pieces, current = [], []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> list[str]:
        tokens = []
        for word in self._clean(text).split():
            tokens.extend(self._split_word(word))
        return tokens

    # -- wordpiece ----------------------------------------------------------

    def wordpiece(self, token: str) -> list[str]:
        """Greedy longest-match-first subword split; [UNK] when stuck."""
        if len(token) > self.max_chars_per_word:
            return [_UNK]
        pieces = []
        start = 0
        while start < len(token):
            end = len(token)
            found = None
            while start < end:
                piece = token[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    found = piece
                    break
                end -= 1
            if found is None:
                return [_UNK]
            pieces.append(found)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        for tok in self.basic_tokenize(text):
            out.extend(self.wordpiece(tok))
        return out

    # -- model-ready encoding ----------------------------------------------

    def encode(self, text_a: str, text_b: str | None = None, *,
               max_len: int = 128) -> dict[str, np.ndarray]:
        """[CLS] a [SEP] (b [SEP]) with padding/truncation — the classic BERT
        sequence-classification encoding."""
        ids_a = [self.vocab[t] for t in self.tokenize(text_a)]
        ids_b = [self.vocab[t] for t in self.tokenize(text_b)] if text_b else []
        if ids_b:
            # pair truncation: trim the longer side first; on ties HF's
            # 'longest_first' removes from the SECOND sequence (its condition
            # is strictly len(a) > len(b)), so match that exactly.
            while len(ids_a) + len(ids_b) > max_len - 3:
                (ids_a if len(ids_a) > len(ids_b) else ids_b).pop()
            ids = [self.cls_id] + ids_a + [self.sep_id] + ids_b + [self.sep_id]
            types = [0] * (len(ids_a) + 2) + [1] * (len(ids_b) + 1)
        else:
            ids_a = ids_a[: max_len - 2]
            ids = [self.cls_id] + ids_a + [self.sep_id]
            types = [0] * len(ids)
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return {
            "input_ids": np.asarray(ids + [self.pad_id] * pad, np.int32),
            "attention_mask": np.asarray(mask + [0] * pad, np.int32),
            "token_type_ids": np.asarray(types + [0] * pad, np.int32),
        }

    def encode_batch(self, texts: list, *, max_len: int = 128) -> dict:
        """Batch encode; each item is a string or an (a, b) pair."""
        encs = [self.encode(*((t,) if isinstance(t, str) else tuple(t)),
                            max_len=max_len) for t in texts]
        if not encs:
            empty = np.zeros((0, max_len), np.int32)
            return {"input_ids": empty, "attention_mask": empty.copy(),
                    "token_type_ids": empty.copy()}
        return {k: np.stack([e[k] for e in encs]) for k in encs[0]}

    def __call__(self, texts, **kwargs):
        """HF-tokenizer-shaped call (padding/truncation implied) so this drops
        into ``datasets._tokenize``'s ``tokenizer`` slot."""
        max_len = kwargs.get("max_length", 128)
        return self.encode_batch(list(texts), max_len=max_len)
