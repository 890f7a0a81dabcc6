"""Attention, fused MLP and preprocessing ops; the CUDA kernels live in
`csrc/` and are built on first use by `_build`."""
