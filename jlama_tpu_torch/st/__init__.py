from .format import DTYPES, TensorInfo, bf16_to_f32, parse_header
from .reader import SafeTensorFile, SafeTensorIndex

__all__ = [
    "DTYPES",
    "TensorInfo",
    "bf16_to_f32",
    "parse_header",
    "SafeTensorFile",
    "SafeTensorIndex",
]
