# Shamir secret-sharing over F_p, accumulating-automata matching, the
# outsourced relation and its dataplane, and the oblivious query suite.
from . import automata, costs, dataplane, encoding, engine, field, shamir
from .costs import CostLedger
from .dataplane import Dispatcher, ShardedRelation, as_dataplane
from .encoding import Codec
from .engine import SecretSharedDB, from_arrays, outsource
from .shamir import Shares, interpolate, reduce_degree, share

__all__ = [
    "field", "shamir", "encoding", "automata", "costs", "dataplane",
    "engine", "SecretSharedDB", "outsource", "from_arrays", "Dispatcher",
    "ShardedRelation", "as_dataplane", "Shares", "share", "interpolate",
    "reduce_degree", "Codec", "CostLedger",
]
