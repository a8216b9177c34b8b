"""Communication/computation cost ledger (reproduces the units of Table 1).

The paper evaluates algorithms on:
  (i)   total bits transferred user <-> cloud,
  (ii)  number of communication rounds,
  (iii) computational cost at the cloud (bits touched),
  (iv)  computational cost at the user (bits touched).

Every query implementation threads a ``CostLedger`` through its phases so the
benchmarks in ``benchmarks/`` print *measured* values next to the paper's
asymptotic claims. One field element counts as w = 31 bits (Mersenne-31).
"""
from __future__ import annotations

import dataclasses

WORD_BITS = 31  # bit-length of one F_p element


@dataclasses.dataclass
class CostLedger:
    rounds: int = 0
    bits_user_to_cloud: int = 0
    bits_cloud_to_user: int = 0
    cloud_ops_bits: int = 0
    user_ops_bits: int = 0

    # -- recording helpers ---------------------------------------------------
    def round(self, n: int = 1) -> None:
        self.rounds += n

    def send(self, n_elems: int) -> None:
        """User -> cloud transfer of n field elements (all clouds counted)."""
        self.bits_user_to_cloud += n_elems * WORD_BITS

    def recv(self, n_elems: int) -> None:
        self.bits_cloud_to_user += n_elems * WORD_BITS

    def cloud(self, n_elems: int) -> None:
        self.cloud_ops_bits += n_elems * WORD_BITS

    def user(self, n_elems: int) -> None:
        self.user_ops_bits += n_elems * WORD_BITS

    # -- reporting ------------------------------------------------------------
    @property
    def communication_bits(self) -> int:
        return self.bits_user_to_cloud + self.bits_cloud_to_user

    def as_dict(self) -> dict:
        return dict(rounds=self.rounds,
                    bits_user_to_cloud=self.bits_user_to_cloud,
                    bits_cloud_to_user=self.bits_cloud_to_user,
                    communication_bits=self.communication_bits,
                    cloud_ops_bits=self.cloud_ops_bits,
                    user_ops_bits=self.user_ops_bits)

    def __str__(self) -> str:
        d = self.as_dict()
        return ", ".join(f"{k}={v}" for k, v in d.items())
