"""SecretSharedDB — the outsourced database (paper §2.1–§2.2).

The trusted DB owner encodes a relation (strings -> unary one-hots, numeric
range columns -> two's-complement bits), secret-shares every bit with an
independent polynomial, and ships one share-relation per cloud. The ``c``
clouds are axis 0 of every share tensor; every share tensor lives on one
torch device (the H100 by default).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .. import _device
from . import encoding
from .costs import CostLedger
from .encoding import Codec
from .shamir import Shares


@dataclasses.dataclass
class SecretSharedDB:
    """One outsourced relation R^s_1..R^s_c plus metadata the adversary knows
    (§2.3: n, m and the schema are public; values and multiplicities are
    hidden)."""
    relation: Shares                 # (c, n, m, W, A) one-hot shares
    codec: Codec
    column_names: Sequence[str]
    numeric: Dict[int, Shares]       # col index -> (c, n, bits) bit shares
    numeric_bits: Dict[int, int]
    base_degree: int = 1

    @property
    def device(self) -> torch.device:
        return self.relation.values.device

    @property
    def n_shares(self) -> int:
        return self.relation.n_shares

    @property
    def n_tuples(self) -> int:
        return self.relation.shape[0]

    @property
    def n_attrs(self) -> int:
        return self.relation.shape[1]

    def column(self, col: int) -> Shares:
        """Share view of one attribute: (c, n, W, A)."""
        return Shares(self.relation.values[:, :, col], self.relation.degree)

    def col_index(self, name: str) -> int:
        return list(self.column_names).index(name)


def outsource(rows: Sequence[Sequence[str]], *, n_shares: int,
              column_names: Optional[Sequence[str]] = None,
              codec: Optional[Codec] = None, degree: int = 1,
              numeric_columns: Optional[Dict[int, int]] = None,
              seed: int = 0,
              generator: Optional[torch.Generator] = None,
              device="cuda") -> SecretSharedDB:
    """DB-owner-side, one-time: encode + share + distribute (Algorithm 1).

    The relation is encoded to alphabet indices on the host, expanded to
    its one-hot on ``device`` and shared there. Share randomness comes from
    ``generator`` (or a fresh one seeded with ``seed`` on ``device``).
    ``numeric_columns`` maps a column index to a bit width; those columns
    are additionally outsourced in binary form (§3.4).
    """
    dev = _device.resolve(device)
    codec = codec or Codec()
    rows = [list(r) for r in rows]
    m = len(rows[0])
    if column_names is None:
        column_names = [f"A{j+1}" for j in range(m)]
    gen = generator if generator is not None else _device.generator(
        _device.as_key(seed), dev)
    idx = codec.encode_indices(rows)                       # (n, m, W)
    relation = encoding.share_encoded(
        encoding.onehot(idx, codec.alphabet_size, dev), n_shares=n_shares,
        degree=degree, generator=gen)
    numeric: Dict[int, Shares] = {}
    numeric_bits: Dict[int, int] = {}
    for col, bits in (numeric_columns or {}).items():
        enc = encoding.encode_number_column([int(r[col]) for r in rows], bits)
        numeric[col] = encoding.share_encoded(
            enc, n_shares=n_shares, degree=degree, generator=gen, device=dev)
        numeric_bits[col] = bits
    return SecretSharedDB(relation=relation, codec=codec,
                          column_names=list(column_names), numeric=numeric,
                          numeric_bits=numeric_bits, base_degree=degree)


def from_arrays(relation, *, degree: int, alphabet: str, word_length: int,
                column_names: Sequence[str],
                numeric: Optional[Mapping[int, np.ndarray]] = None,
                numeric_bits: Optional[Mapping[int, int]] = None,
                base_degree: int = 1, device="cuda") -> SecretSharedDB:
    """Build a port DB from share arrays made elsewhere.

    ``relation`` is a uint32 (c, n, m, W, A) share array (for example
    ``np.asarray(db.relation.values)`` of a reference-package DB) and
    ``numeric`` maps column index -> (c, n, bits) share arrays, all of
    degree ``degree``. Both packages then query identical shares.
    """
    dev = _device.resolve(device)

    def put(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.size and int(a.max()) >= 2**31 - 1:
            raise ValueError("share values must lie in [0, p)")
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    return SecretSharedDB(
        relation=Shares(put(relation), degree),
        codec=Codec(alphabet=alphabet, word_length=word_length),
        column_names=list(column_names),
        numeric={int(c): Shares(put(v), degree)
                 for c, v in (numeric or {}).items()},
        numeric_bits={int(c): int(b) for c, b in (numeric_bits or {}).items()},
        base_degree=base_degree)


def fresh_ledger() -> CostLedger:
    return CostLedger()
