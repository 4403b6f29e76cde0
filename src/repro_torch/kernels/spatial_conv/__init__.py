"""Spatial (direct) convolution on the Spatial-mode PE (K1).

The paper's Spatial mode merges all GEMM cores into one large broadcast array
(Sec. 4.2.2) — here: one patch GEMM, which reads its patches from the map
itself or, for the shapes it cannot, from im2col's patch matrix.
"""
from repro_torch.kernels.spatial_conv.ops import spatial_conv2d

__all__ = ["spatial_conv2d"]
