"""Device policy shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises: the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: repro_torch runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("float32", "bfloat16", ...) -> torch dtype."""
    return getattr(torch, name)


def to_device(values, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values (a list or numpy array) as a new tensor on ``device``.
    On the card the copy goes through pinned memory and is only enqueued:
    the host does not wait for the stream, so no device work already in
    flight is waited for (a plain host-to-card copy would)."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
