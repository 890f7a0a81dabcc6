"""Optimizer, train state and trainer of the pretrain_mum step (counterpart
of `exploremultimodal_tpu/train`)."""
