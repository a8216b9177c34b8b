"""repro_torch: the PyTorch/CUDA port of the secret-shared query suite.

Shamir secret-sharing over F_p (Mersenne-31), accumulating-automata string
matching and the oblivious count, selection, range, aggregation and
embedding-lookup queries behind ``repro_torch.api.QueryClient``, on torch
tensors (``repro_torch.models.private_embed`` holds the lookup's table
set-up), served by ``repro_torch.launch.QueryServer`` and run as MapReduce
jobs by ``repro_torch.api.MapReduceExecutor`` over
``repro_torch.runtime``. The hot kernels (the AA match, the share-space matmul, the SS-SUB
ripple and the fused one-hot sharing) are CUDA C++ written for the H100
(``repro_torch.kernels``). Share tensors are int32
holding [0, p).
"""
__version__ = "0.1.0"
