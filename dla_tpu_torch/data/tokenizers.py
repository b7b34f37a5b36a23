"""Tokenizer layer (host side).

``ByteTokenizer`` is the dependency-free byte-level tokenizer the tests,
smoke runs and committed checkpoints use: UTF-8 bytes shifted by 3, ids
0/1/2 = pad/bos/eos — identical ids to ``dla_tpu.data.tokenizers``, so
prompts encode the same in both packages. The HF tokenizer adapter waits
for a later slice of the port; ``load_tokenizer`` raises for any name
other than the byte tokenizer's.
"""
from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    pad_token_id: int
    eos_token_id: int
    bos_token_id: Optional[int]
    vocab_size: int

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = False) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes shifted by 3; ids 0/1/2 = pad/bos/eos. vocab_size 259."""

    def __init__(self) -> None:
        self.pad_token_id = 0
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.vocab_size = 259

    def encode(self, text: str, *, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 3 for i in ids if 3 <= i <= 258)
        return data.decode("utf-8", errors="replace")


def load_tokenizer(name_or_path: str) -> Tokenizer:
    """'byte' (or its aliases) -> ByteTokenizer. HF tokenizers are not
    ported yet: any other name raises instead of silently substituting
    the byte vocabulary."""
    if name_or_path in ("byte", "bytes", "test"):
        return ByteTokenizer()
    raise NotImplementedError(
        f"tokenizer '{name_or_path}': only the byte tokenizer is ported; "
        "HF tokenizers arrive with the HF-import slice (pass "
        "tokenizer='byte')")
