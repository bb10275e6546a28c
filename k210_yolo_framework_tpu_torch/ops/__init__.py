"""Plain-torch ops and the five CUDA-backed ones: the fused decode+NMS head,
NMS alone, the fused depthwise-separable block, the augment's 3-shear
rotation and the conv epilogue."""
