"""Plain-torch ops and the four CUDA-backed ones: the fused decode+NMS head,
NMS alone, the fused depthwise-separable block and the augment's 3-shear
rotation."""
