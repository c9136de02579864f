"""Data, tensor and spatial parallelism over ``torch.distributed``."""
