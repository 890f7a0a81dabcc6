"""Host-side data: the VQA answer vocabulary, and the synthetic pretrain
dataset with its masking generator and batching."""
