from .format import DTYPES, NUMPY_TO_ST, TensorInfo, bf16_to_f32, parse_header, serialize_header
from .http_loader import HTTPSafeTensorIndex, HTTPSafeTensorLoader, is_url, open_weights
from .reader import SafeTensorFile, SafeTensorIndex
from .writer import SafeTensorWriter

__all__ = [
    "DTYPES",
    "NUMPY_TO_ST",
    "TensorInfo",
    "bf16_to_f32",
    "parse_header",
    "serialize_header",
    "HTTPSafeTensorIndex",
    "HTTPSafeTensorLoader",
    "is_url",
    "open_weights",
    "SafeTensorFile",
    "SafeTensorIndex",
    "SafeTensorWriter",
]
