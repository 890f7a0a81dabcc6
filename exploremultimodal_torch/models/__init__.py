"""VLMo backbone, heads and task for serving."""

from exploremultimodal_torch.models.task import VlmoTask, build_model

__all__ = ["VlmoTask", "build_model"]
