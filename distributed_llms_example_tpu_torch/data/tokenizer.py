"""Tokenizers (the port's own copy of the JAX package's ``data/tokenizer.py``).

- ``ByteTokenizer``: dependency-free byte-level tokenizer (UTF-8 bytes
  shifted past the special ids), so every pipeline runs with no assets;
- ``HFTokenizer``: a Hugging Face tokenizer loaded from *local* files only.

Sequences are requested by role (source / target / prompt /
continuation) and the tokenizer applies the family's special-token layout.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    eos_id: int

    def encode(self, text: str) -> list[int]: ...

    def encode_source(self, text: str, max_length: int) -> list[int]: ...

    def encode_target(self, text: str, max_length: int) -> list[int]: ...

    def encode_prompt(self, text: str, max_length: int) -> list[int]: ...

    def encode_continuation(self, text: str, max_length: int) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + {pad=0, eos=1}; ids are byte+2.  Sources/targets end in
    one EOS, prompts carry no specials."""

    OFFSET = 2

    def __init__(self) -> None:
        self.pad_id = 0
        self.eos_id = 1
        self.vocab_size = 256 + self.OFFSET

    def encode(self, text: str) -> list[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def encode_source(self, text: str, max_length: int) -> list[int]:
        return self.encode(text)[: max_length - 1] + [self.eos_id]

    encode_target = encode_source
    encode_continuation = encode_source

    def encode_prompt(self, text: str, max_length: int) -> list[int]:
        return self.encode(text)[:max_length]

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside the byte range are skipped: models may have a larger
        # vocab than the tokenizer and random weights emit arbitrary ids
        data = bytes(i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """A Hugging Face tokenizer loaded from a local directory; ids match
    ``AutoTokenizer.__call__(text, max_length=..., truncation=True)``."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.pad_id = self._tok.pad_token_id if self._tok.pad_token_id is not None else 0
        self._has_eos = self._tok.eos_token_id is not None
        self.eos_id = self._tok.eos_token_id if self._has_eos else 1

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def encode_source(self, text: str, max_length: int) -> list[int]:
        return self._tok(text, max_length=max_length, truncation=True)["input_ids"]

    def encode_target(self, text: str, max_length: int) -> list[int]:
        return self._tok(text_target=text, max_length=max_length, truncation=True)["input_ids"]

    def encode_prompt(self, text: str, max_length: int) -> list[int]:
        ids = self._tok(text, max_length=max_length, truncation=True)["input_ids"]
        while self._has_eos and ids and ids[-1] == self.eos_id:
            ids = ids[:-1]
        return ids

    def encode_continuation(self, text: str, max_length: int) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if not self._has_eos:
            return ids[:max_length]
        return ids[: max_length - 1] + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def get_tokenizer(spec: str, model_ckpt: str = "") -> Tokenizer:
    """Resolve a tokenizer spec: explicit path > model checkpoint dir > byte."""
    if spec and spec != "byte":
        return HFTokenizer(spec)
    if spec == "byte":
        return ByteTokenizer()
    if model_ckpt and os.path.isdir(model_ckpt):
        try:
            return HFTokenizer(model_ckpt)
        except Exception:  # no tokenizer in the directory: bytes, as the JAX package
            pass
    return ByteTokenizer()
