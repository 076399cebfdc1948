"""Offline model quantization: HF checkpoint -> JQ4/I8 checkpoint.

The counterpart of `jlama_tpu/quant/quantizer.py`, with the same rule, files
and bytes: every 2-D float weight matrix (not a norm or a bias, last dim a
multiple of 32) is quantized to Q4 (or I8) with its `.qb` block scales,
skip/drop prefixes are honoured, one `model.safetensors` is written with
the config and tokenizer files copied beside it into `<model>-JQ4/` (or
`-JI8`), and a model-card header is prepended to README.md.

Each tensor is quantized on `device` (CUDA unless the caller names one), one
at a time, host -> card -> host, so a model larger than the card's memory
still quantizes; `quant.blockq.q4_quantize` and `q8_quantize_checkpoint`
give `q4_quantize_np`'s and `q8_quantize_np`'s bytes on any device. (The
JAX quantizer runs host C++ kernels, `jlama_tpu/native.py`, where they
build, with the same bytes; the port has no host kernels.)
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..st import SafeTensorIndex, SafeTensorWriter
from . import blockq

COPY_FILES = (
    "config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "generation_config.json",
    "special_tokens_map.json",
)

CARD_HEADER = """# Quantized version of {name}

This model is a quantized variant of the {name} model, optimized for use with
jlama-tpu, a TPU-native inference engine implementing the Jlama JQ4 format.
Block-wise 4-bit quantization (32-element blocks, per-block scales) reduces
the model's size and HBM bandwidth while maintaining accuracy.

"""


def _quantizable(name: str, shape: tuple[int, ...], dtype: str) -> bool:
    if dtype not in ("F32", "F16", "BF16"):
        return False
    if len(shape) != 2:
        return False  # norms/biases stay float
    if shape[-1] % blockq.BLOCK_SIZE != 0:
        return False
    if "norm" in name.lower() or "bias" in name.lower():
        return False
    return True


def _to_device_f32(arr: np.ndarray, st_dtype: str, device: torch.device) -> torch.Tensor:
    """A stored tensor as f32 on the device (BF16 bit patterns widened there)."""
    if st_dtype == "BF16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).to(device).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(device)
    return t.to(torch.float32)


def quantize_model(
    model_dir: str | Path,
    out_dir: str | Path | None = None,
    quantize_to: str = "q4",  # q4 | i8
    skip_prefixes: tuple[str, ...] = (),
    drop_prefixes: tuple[str, ...] = (),
    progress=None,
    device=None,
) -> Path:
    device = resolve_device(device)
    model_dir = Path(model_dir)
    suffix = {"q4": "JQ4", "i8": "JI8"}[quantize_to]
    out = Path(out_dir) if out_dir else model_dir.parent / f"{model_dir.name}-{suffix}"
    out.mkdir(parents=True, exist_ok=True)

    idx = SafeTensorIndex(model_dir)
    w = SafeTensorWriter(metadata={"format": "pt", "quantized_by": "jlama-tpu"})
    names = [n for n in idx.names() if not n.endswith(".qb")]
    with torch.inference_mode():
        for i, name in enumerate(names):
            if any(name.startswith(p) for p in drop_prefixes):
                continue
            info = idx.info(name)
            skip = any(p in name for p in skip_prefixes)
            arr = idx.load(name)
            if not skip and _quantizable(name, info.shape, info.dtype):
                x = _to_device_f32(arr, info.dtype, device)
                if quantize_to == "q4":
                    packed, scales = blockq.q4_quantize(x)
                    w.add_q4(name, packed.cpu().numpy(), scales.cpu().numpy())
                else:
                    values, scales = blockq.q8_quantize_checkpoint(x)
                    w.add_i8(name, values.cpu().numpy(), scales.cpu().numpy())
                del x
            elif info.dtype == "BF16":  # uint16 bit patterns: no numpy bf16 here
                w.add_raw(name, "BF16", info.shape, np.array(arr))
            else:
                w.add(name, np.array(arr))
            if progress:
                progress(name, i + 1, len(names))
    idx.close()
    w.write(out / "model.safetensors")

    for f in COPY_FILES:
        src = model_dir / f
        if src.exists():
            shutil.copyfile(src, out / f)
    readme = model_dir / "README.md"
    header = CARD_HEADER.format(name=model_dir.name)
    if readme.exists():
        (out / "README.md").write_text(header + readme.read_text())
    else:
        (out / "README.md").write_text(header)
    return out
