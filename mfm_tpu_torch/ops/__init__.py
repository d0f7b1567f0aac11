"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

- ``field``     K1, the fused vector-field apply with K x-tangents
- ``pairwise``  K2a/K2b, the pairwise Stein and RBF sums
- ``phi_four``  K3, the phi^4 log-likelihood and its score in one pass
- ``build``     nvcc build on first use and the ctypes loader
"""
