"""BERT WordPiece tokenizer in Python and numpy, with no transformers
dependency: a copy of the JAX package's utils/tokenizer.py.

BLIP's text side is a BERT tokenizer (the reference loads it through
``BlipProcessor``, src/tagging/vlm_tagger.py:119-156).  A portable ``.npz``
checkpoint with its ``vocab.txt`` (tools/export_weights.py) lets the torch
BLIP backend (tagging/vlm.py) caption on a machine without transformers, so
the tokenizer is self-contained too.  It implements the bert-base-uncased
pipeline (BasicTokenizer: text cleanup, CJK isolation, lowercase and accent
strip, punctuation split; then greedy longest-match WordPiece) and HF's
decode cleanup; tests/test_torch_vlm.py holds it to the JAX package's copy.

The class exposes the HuggingFace surface the VLM backend uses:
``tokenizer(text, return_tensors="np")["input_ids"]`` and
``tokenizer.decode(ids, skip_special_tokens=True)``.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Sequence

import numpy as np

_MAX_WORD_CHARS = 100  # transformers WordpieceTokenizer.max_input_chars_per_word


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation by BERT even when unicode says
    # otherwise (e.g. "$", "^", "`").
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """bert-base-uncased-compatible tokenizer over a vocab.txt vocabulary."""

    def __init__(
        self,
        vocab: Iterable[str],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        mask_token: str = "[MASK]",
    ):
        # Mirror HF BertTokenizer.load_vocab exactly: id = position in the
        # token sequence (blank/duplicate lines included), duplicate tokens
        # keep the LAST id in the token->id map, and id->token is rebuilt
        # from that map (an earlier duplicate's id decodes to [UNK], as in
        # transformers' ids_to_tokens).  Anything else silently shifts every
        # subsequent token id vs the model's embedding rows.
        self._tokens = list(vocab)
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(self._tokens)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.unk_token = unk_token
        self.cls_token = cls_token
        self.sep_token = sep_token
        self.special_tokens = {unk_token, cls_token, sep_token, pad_token, mask_token}
        self.cls_token_id = self.vocab.get(cls_token, 0)
        self.sep_token_id = self.vocab.get(sep_token, 0)
        self.unk_token_id = self.vocab.get(unk_token, 0)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        """Load a BERT ``vocab.txt`` (one token per line, id = line index —
        blank lines included, exactly as transformers' load_vocab)."""
        with open(path, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f.readlines()]
        return cls(vocab, **kw)

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for tok in self._tokens:
                f.write(tok + "\n")

    # -- basic tokenization (transformers BasicTokenizer) --------------------
    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch
            for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_on_punc(token: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]

    def _basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            tokens.extend(self._split_on_punc(tok))
        return [t for t in tokens if t]

    # -- WordPiece ------------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > _MAX_WORD_CHARS:
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

    # -- public API ------------------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        # Special tokens appearing IN the text stay atomic (HF keeps them
        # via never_split / the added-tokens trie); without this,
        # '[SEP]' would basic-tokenize to '[', 'sep', ']'.
        for part, is_special in self._split_on_special(text):
            if is_special:
                out.append(part)
                continue
            for word in self._basic_tokenize(part):
                out.extend(self._wordpiece(word))
        return out

    def _split_on_special(self, text: str):
        """[(segment, is_special_token), ...] — special tokens matched
        anywhere, like HF's added-tokens trie."""
        import re

        if not self.special_tokens:
            return [(text, False)]
        pat = "|".join(
            re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)
        )
        parts = []
        pos = 0
        for m in re.finditer(pat, text):
            if m.start() > pos:
                parts.append((text[pos : m.start()], False))
            parts.append((m.group(0), True))
            pos = m.end()
        if pos < len(text):
            parts.append((text[pos:], False))
        return parts

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.cls_token_id] + ids + [self.sep_token_id]
        return ids

    def __call__(self, text: str, return_tensors: str = "np"):
        ids = self.encode(text)
        if return_tensors == "np":
            return {"input_ids": np.asarray([ids], np.int32)}
        return {"input_ids": [ids]}

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.inv_vocab.get(int(i), self.unk_token)
            if skip_special_tokens and tok in self.special_tokens:
                continue
            tokens.append(tok)
        text = " ".join(tokens).replace(" ##", "")
        return self._clean_up_tokenization(text)

    @staticmethod
    def _clean_up_tokenization(text: str) -> str:
        """transformers.tokenization_utils_base.clean_up_tokenization."""
        return (
            text.replace(" .", ".")
            .replace(" ?", "?")
            .replace(" !", "!")
            .replace(" ,", ",")
            .replace(" ' ", "'")
            .replace(" n't", "n't")
            .replace(" 'm", "'m")
            .replace(" 's", "'s")
            .replace(" 've", "'ve")
            .replace(" 're", "'re")
        )
