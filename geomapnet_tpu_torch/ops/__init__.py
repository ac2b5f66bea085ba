"""Image preprocessing on the device, and the hand-written CUDA kernel."""
