"""Host-side data: the BERT tokenizer and MLM collators, the image
transforms and the native JPEG loader, the arrow, text-corpus and
synthetic datasets, the VQA answer vocabulary, the patch maskers, and the
threaded loader that batches them for a phase (`datamodule.MultiTaskData`)."""
