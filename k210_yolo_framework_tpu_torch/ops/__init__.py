"""Plain-torch ops and the two CUDA-backed ones: the fused decode+NMS head
and the augment's 3-shear rotation."""
