"""Device selection: entry points run on the card unless asked for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "check_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device, raising when no GPU
    is present; ``"cpu"`` -> the CPU (the plain PyTorch versions)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return dev if dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on: ``cpu`` or ``cuda``.

    A CPU tensor selects the plain version and a CUDA tensor the kernel;
    mixed devices and any other device type raise.
    """
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; tensors must lie on "
                         "'cuda' or 'cpu'")
    return dev
