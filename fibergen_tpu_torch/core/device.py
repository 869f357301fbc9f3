"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without a
card they raise instead of falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device`` for an entry point: ``None`` means ``cuda``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fibergen_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_dtype(name) -> torch.dtype:
    """torch dtype of an options dtype name ('float32' or 'float64')."""
    dt = {"float32": torch.float32, "float64": torch.float64}.get(name)
    if dt is None:
        raise ValueError(f"unsupported dtype {name!r}")
    return dt
