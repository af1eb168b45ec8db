"""Text → ids for the benchmark's texts: lowercase words, spaces and
punctuation, which the English cleaners leave as they are (a copy of the
Tacotron symbol table's first entries; the end-of-sequence id appended)."""

from __future__ import annotations

import numpy as np

EOS_ID = 1
_CHARACTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "
_IDS = {c: 2 + i for i, c in enumerate(_CHARACTERS)}


def encode(text: str) -> np.ndarray:
    text = " ".join(text.lower().split())
    return np.asarray([_IDS[c] for c in text] + [EOS_ID], np.int64)
