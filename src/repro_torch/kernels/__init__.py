# Hand-written CUDA kernels for the H100 (csrc/*.cu, built with nvcc at
# first use) beside their plain PyTorch versions:
#   aa_match  — fused accumulating-automata match (§3.1 Table 3),
#   ss_matmul — share-space mod-p matmul (oblivious fetch, one_tuple,
#               conditional SUM, the embedding lookup) and the fused
#               one-hot sharing that feeds the lookup (share_onehot.cu),
#   ripple    — k chained SS-SUB bit steps (§3.4 Alg 6: range predicates,
#               the MIN/MAX tournament).
# ops.py holds the public wrappers and their launch counters; ref.py the
# literal int64 oracles the tests hold both against.
from . import ops, ref

__all__ = ["ops", "ref"]
