"""repro_torch: the PyTorch/CUDA port of the secret-shared query suite.

Shamir secret-sharing over F_p (Mersenne-31), accumulating-automata string
matching and the oblivious count, selection, range and aggregation queries
behind ``repro_torch.api.QueryClient``, on torch tensors. The hot kernels
(the AA match, the share-space matmul and the SS-SUB ripple) are CUDA C++
written for the H100 (``repro_torch.kernels``). Share tensors are int32
holding [0, p).
"""
__version__ = "0.1.0"
