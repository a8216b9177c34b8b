"""paper_db: the paper's OWN workload at production scale — the oblivious
query engine (count / select / PK-FK join) over a secret-shared relation,
tuples sharded across the data axis, alphabet/attribute work on the model
axis. Used by the dry-run as the paper-representative cell."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperDBConfig:
    name: str = "paper_db"
    n_tuples: int = 1 << 20        # 1M tuples
    n_attrs: int = 8
    word_length: int = 12
    alphabet_size: int = 64
    n_shares: int = 4              # clouds simulated per program
    degree: int = 1
    fetch_rows: int = 256          # ℓ' padded fetch-matrix rows


def full() -> PaperDBConfig:
    return PaperDBConfig()


def smoke() -> PaperDBConfig:
    return PaperDBConfig(n_tuples=64, n_attrs=3, word_length=6,
                         alphabet_size=16, fetch_rows=4)
