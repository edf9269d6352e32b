"""Gathers over optional leading batch dims.

The tracking step runs S sequences at once on tensors with a leading
sequence axis, and the same functions run one frame without it. Plain
indexing (`a[idx]`, `img[y, x]`) does not carry a batch axis, so the
functions of the step gather through these two helpers, which take any
number of leading batch dims (none included). `to_host` pulls a list of
results to numpy with one synchronization, and `resolve_device` gives
the device every entry point runs on.
"""
from __future__ import annotations

import torch


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of `a` (*B, L, *C) at integer `idx` (*B, N) -> (*B, N, *C):
    `a[idx]` for each batch element."""
    nb = idx.dim() - 1
    flat = a.reshape(a.shape[: nb + 1] + (-1,))
    out = flat.gather(nb, idx[..., None].expand(idx.shape + (flat.shape[-1],)))
    return out.reshape(idx.shape + a.shape[nb + 1 :])


def gather_pixels(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`img[y, x]` for each batch element: img (*B, H, W), integer y and x
    (*B, *K) inside the image -> (*B, *K)."""
    nb = img.dim() - 2
    flat = img.reshape(img.shape[:nb] + (-1,))
    idx = (y * img.shape[-1] + x).reshape(y.shape[:nb] + (-1,))
    return flat.gather(-1, idx).reshape(y.shape)


def to_host(tensors):
    """Copy a sequence of tensors to host numpy with ONE synchronization:
    all device-to-host copies are queued non-blocking, then the stream is
    synchronized once."""
    dev = next((t.device for t in tensors if t.device.type == "cuda"), None)
    host = [t.to("cpu", non_blocking=True) if t.device.type == "cuda" else t for t in tensors]
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in host]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A CUDA device without a card is an error, never a quiet
    fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hfvo_tpu_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device
