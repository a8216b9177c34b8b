"""Unary (one-hot) and binary encodings of relation values (paper §2.1, §3.4).

Strings are encoded character by character as one-hot vectors over a fixed
alphabet, padded to a fixed word length with a terminator symbol (the
paper's fix for the John/Johnson prefix problem, §3.1.2 Aside). Numbers for
range queries are two's-complement bit vectors, LSB first.

Host-side encoders return numpy uint32 arrays with the reference package's
layout. A whole relation is encoded as alphabet *indices* with one
vectorised lookup (:meth:`Codec.encode_indices`) and expanded to its
one-hot form on the device (:func:`onehot`), so the full one-hot never
crosses from the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import shamir
from .field import DTYPE
from .shamir import Shares

# Default alphabet: terminator + space + a-z + A-Z + 0-9 + a few symbols.
# Index 0 is the terminator/pad so padded positions still match each other.
TERMINATOR = "\0"
DEFAULT_ALPHABET = TERMINATOR + " abcdefghijklmnopqrstuvwxyz" \
    + "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.-_/@"


@dataclasses.dataclass(frozen=True)
class Codec:
    """Fixed (alphabet, word_length) unary codec."""
    alphabet: str = DEFAULT_ALPHABET
    word_length: int = 12

    @property
    def alphabet_size(self) -> int:
        return len(self.alphabet)

    def char_index(self, ch: str) -> int:
        i = self.alphabet.find(ch)
        if i < 0:
            raise ValueError(f"character {ch!r} not in alphabet")
        return i

    # -- host-side (numpy) encode: runs at the trusted DB owner / user ------
    def encode_indices(self, words) -> np.ndarray:
        """Alphabet index of every character: words of any array shape ->
        int64[*shape, word_length], terminator-padded (index 0).

        One numpy lookup for the whole array: a fixed-width unicode array
        pads short words with NUL, which is the terminator."""
        arr = np.asarray(words, dtype=object)
        lengths = np.vectorize(len, otypes=[np.int64])(arr) if arr.size \
            else np.zeros(arr.shape, np.int64)
        if arr.size and lengths.max() > self.word_length:
            bad = arr.reshape(-1)[int(np.argmax(lengths.reshape(-1)))]
            raise ValueError(f"word {bad!r} longer than {self.word_length}")
        fixed = arr.astype(f"U{self.word_length}")
        codes = fixed.view(np.uint32).reshape(arr.shape + (self.word_length,))
        lut = np.full(max(max(map(ord, self.alphabet)), int(codes.max(
            initial=0))) + 1, -1, dtype=np.int64)
        lut[[ord(ch) for ch in self.alphabet]] = np.arange(self.alphabet_size)
        idx = lut[codes]
        if (idx < 0).any():
            bad = chr(int(codes[idx < 0].reshape(-1)[0]))
            raise ValueError(f"character {bad!r} not in alphabet")
        return idx

    def encode_word(self, word: str) -> np.ndarray:
        """-> uint32[word_length, alphabet_size] one-hot rows."""
        return _onehot_np(self.encode_indices([word])[0], self.alphabet_size)

    def encode_column(self, words: Sequence[str]) -> np.ndarray:
        """-> uint32[n, word_length, alphabet_size]."""
        return _onehot_np(self.encode_indices(list(words)),
                          self.alphabet_size)

    def encode_relation(self, rows: Sequence[Sequence[str]]) -> np.ndarray:
        """-> uint32[n, m, word_length, alphabet_size]."""
        return _onehot_np(self.encode_indices([list(r) for r in rows]),
                          self.alphabet_size)

    def decode_word(self, onehot: np.ndarray) -> str:
        """Inverse of encode_word; tolerant of all-zero (eliminated) rows."""
        chars = []
        for j in range(onehot.shape[0]):
            nz = np.nonzero(onehot[j])[0]
            if len(nz) == 0:
                return ""          # an obliviously-eliminated tuple
            ch = self.alphabet[int(nz[0])]
            if ch == TERMINATOR:
                break
            chars.append(ch)
        return "".join(chars)

    def decode_row(self, onehot: np.ndarray) -> list:
        return [self.decode_word(onehot[k]) for k in range(onehot.shape[0])]


def _onehot_np(idx: np.ndarray, a: int) -> np.ndarray:
    out = np.zeros(idx.shape + (a,), dtype=np.uint32)
    np.put_along_axis(out, idx[..., None], 1, axis=-1)
    return out


def onehot(idx, alphabet_size: int, device) -> torch.Tensor:
    """Alphabet indices -> int32 one-hot built on ``device``."""
    t = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)
    out = torch.zeros(tuple(t.shape) + (alphabet_size,), dtype=DTYPE,
                      device=device)
    out.scatter_(-1, t.unsqueeze(-1), 1)
    return out


# ---------------------------------------------------------------------------
# Secret-shared encodings
# ---------------------------------------------------------------------------

def share_encoded(encoded, *, n_shares: int, degree: int = 1,
                  generator: Optional[torch.Generator] = None,
                  coeffs: Optional[torch.Tensor] = None,
                  device=None) -> Shares:
    """Secret-share an encoded (one-hot / bit) tensor, fresh poly per bit."""
    if not isinstance(encoded, torch.Tensor):
        encoded = torch.from_numpy(np.asarray(encoded).astype(np.int32))
    if device is not None:
        encoded = encoded.to(device)
    return shamir.share(encoded, n_shares=n_shares, degree=degree,
                        coeffs=coeffs, generator=generator)


def share_pattern(codec: Codec, pattern: str, *, n_shares: int,
                  degree: int = 1,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Shares:
    """User-side: encode + secret-share a query predicate (count/select)."""
    return share_encoded(codec.encode_word(pattern), n_shares=n_shares,
                         degree=degree, generator=generator, device=device)


# ---------------------------------------------------------------------------
# Binary (two's-complement) encoding for range queries (§3.4)
# ---------------------------------------------------------------------------

def encode_number_bits(x: int, n_bits: int) -> np.ndarray:
    """Two's-complement bits, LSB first -> uint32[n_bits]."""
    if not (-(1 << (n_bits - 1)) <= x < (1 << (n_bits - 1))):
        raise ValueError(f"{x} out of range for {n_bits}-bit two's complement")
    ux = x & ((1 << n_bits) - 1)
    return np.asarray([(ux >> i) & 1 for i in range(n_bits)], dtype=np.uint32)


def encode_number_column(xs: Sequence[int], n_bits: int) -> np.ndarray:
    return np.stack([encode_number_bits(int(x), n_bits) for x in xs])


def decode_number_bits(bits: np.ndarray) -> int:
    n = len(bits)
    ux = sum(int(b) << i for i, b in enumerate(bits))
    return ux - (1 << n) if ux >= (1 << (n - 1)) else ux
