"""Plain-torch ops and the CUDA-backed fused head."""
