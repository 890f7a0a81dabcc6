"""PyTorch/CUDA port of exploremultimodal_tpu for one NVIDIA H100.

This slice serves VQA (`infer.Predictor`) on the VLMo backbone, with the
flash-attention forward and the fused bf16 MLP as hand-written CUDA kernels
(`ops/csrc`). It imports neither JAX nor `exploremultimodal_tpu`; entry
points run on CUDA unless the caller passes `device="cpu"`.
"""
