"""Bucket geometry and timing helpers."""

from .config import BucketConfig
from .profiling import Meter, cuda_timer

__all__ = ["BucketConfig", "Meter", "cuda_timer"]
