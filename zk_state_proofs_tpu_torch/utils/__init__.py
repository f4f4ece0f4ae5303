"""Config, error taxonomy, timing and profiling."""

from .config import BucketConfig, Config
from .errors import MissingKeyError, PackingError, VerificationError, WitnessError
from .profiling import Meter, cuda_timer, cuda_trace, timed

__all__ = [
    "BucketConfig",
    "Config",
    "MissingKeyError",
    "PackingError",
    "VerificationError",
    "WitnessError",
    "Meter",
    "cuda_timer",
    "cuda_trace",
    "timed",
]
