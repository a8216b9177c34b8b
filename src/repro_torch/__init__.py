"""repro_torch: the PyTorch/CUDA port of the secret-shared query suite.

Shamir secret-sharing over F_p (Mersenne-31), accumulating-automata string
matching and the oblivious count/selection queries behind
``repro_torch.api.QueryClient``, on torch tensors. The two hot kernels
(the AA match and the share-space matmul) are CUDA C++ written for the
H100 (``repro_torch.kernels``). Share tensors are int32 holding [0, p).
"""
__version__ = "0.1.0"
