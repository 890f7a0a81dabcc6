"""PyTorch/CUDA port of exploremultimodal_tpu for NVIDIA H100s.

It trains every phase and serves every endpoint of the VLMo stack, with
each Pallas kernel of the JAX package hand-written for Hopper in CUDA
(`ops/csrc`), on one process or, under a `parallel` preset, on several
(`parallel/`). It imports neither JAX nor `exploremultimodal_tpu`; entry
points run on CUDA unless the caller passes `device="cpu"`.
"""
