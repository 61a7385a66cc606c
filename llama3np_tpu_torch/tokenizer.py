"""SentencePiece-style greedy-merge BPE tokenizer (host code).

A copy of `llama3np_tpu.tokenizer.Tokenizer`, byte-compatible with the
reference tokenizer: the JSON model format ``{"tokens": [...], "scores":
[...]}``, the merge order (leftmost pair whose merged string has the strictly
greatest score), and the reference's observable quirks:

* decode() strips the *character set* ``{<, s, /, >}`` from both ends of the
  decoded string (quirk Q3).  Disable with ``fix_decode=True``.
* encode() silently drops characters absent from the vocab (no byte
  fallback).

The optional C++ merge core (`native/bpe.cpp`) and the Python loop below
compute the same thing; the Python loop is the host-side twin, used where no
C++ compiler is present.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List


class Tokenizer:
    def __init__(self, model_path: str, fix_decode: bool = False,
                 backend: str = "auto"):
        with open(model_path, encoding="utf-8") as f:
            model = json.load(f)
        self.vocab: List[str] = model["tokens"]
        self.scores: List[float] = model["scores"]
        self.bos_id = 1
        self.eos_id = 2
        self.fix_decode = fix_decode
        # First-occurrence index, matching list.index for duplicate tokens.
        index: Dict[str, int] = {}
        for i, tok in enumerate(self.vocab):
            if tok not in index:
                index[tok] = i
        self._index = index
        # backend: "auto" (native if buildable), "native", "python".
        self._native = None
        if backend in ("auto", "native"):
            from .native import NativeBPE
            try:
                self._native = NativeBPE(self.vocab, self.scores)
            except RuntimeError:
                if backend == "native":
                    raise

    # -- reference API ------------------------------------------------------

    def str_lookup(self, token: str) -> int:
        """Vocab id of `token`, or -1."""
        return self._index.get(token, -1)

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        if self._native is not None:
            tokens = self._native.encode(text)
            if add_bos:
                tokens.insert(0, self.bos_id)
            if add_eos:
                tokens.append(self.eos_id)
            return tokens
        return self._encode_py(text, add_bos, add_eos)

    def _encode_py(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        vocab, scores, index = self.vocab, self.scores, self._index

        # Seed with per-character ids; unknown characters are dropped.
        tokens: List[int] = []
        for ch in text:
            tid = index.get(ch, -1)
            if tid >= 0:
                tokens.append(tid)

        # Greedy merge: repeatedly fuse the adjacent pair whose concatenation
        # has the strictly greatest score; ties resolve to the leftmost pair.
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for i in range(len(tokens) - 1):
                merged_id = index.get(vocab[tokens[i]] + vocab[tokens[i + 1]], -1)
                if merged_id != -1 and scores[merged_id] > best_score:
                    best_score = scores[merged_id]
                    best_id = merged_id
                    best_idx = i
            if best_idx == -1:
                break
            tokens[best_idx : best_idx + 2] = [best_id]

        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.vocab[i] for i in ids)
        if self.fix_decode:
            # Corrected semantics: remove the literal marker tokens only.
            if text.startswith("<s>"):
                text = text[3:]
            if text.endswith("</s>"):
                text = text[:-4]
            return text
        # Reference semantics: strip the character set (quirk Q3).
        return text.strip("<s>").strip("</s>")

    # -- extensions ---------------------------------------------------------

    def encode_batch(self, texts: Iterable[str], add_bos: bool = True, add_eos: bool = False) -> List[List[int]]:
        return [self.encode(t, add_bos, add_eos) for t in texts]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)
