"""pretrain_mum objectives (counterpart of `exploremultimodal_tpu/objectives`)."""
