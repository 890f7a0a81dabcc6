from exploremultimodal_torch.utils.logging import create_logger
from exploremultimodal_torch.utils.metrics import MetricLogger, SmoothedValue

__all__ = ["create_logger", "MetricLogger", "SmoothedValue"]
