"""Device selection shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: no quiet
fallback, so a machine without CUDA fails loudly instead of serving on the
host.  ``meta`` (shapes without data) is accepted for the dry run
(``launch/dryrun.py``), which traces a rank's program and runs none of it."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``.  Raises if CUDA is asked for (explicitly or
    by default) and absent.  ``meta`` is taken as it is."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def generator(device: Optional[Union[str, torch.device]], seed: int
              ) -> torch.Generator:
    """A generator seeded with ``seed`` for drawing on ``device`` (None: the
    host); on ``meta``, which has none, a host one (a draw on meta makes no
    data)."""
    dev = torch.device("cpu" if device is None else device)
    return torch.Generator(device="cpu" if dev.type == "meta" else dev
                           ).manual_seed(seed)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# words of a card's name that say no more than "an NVIDIA card"
_BRAND_WORDS = ("nvidia", "geforce", "rtx", "tesla", "quadro")


def platform_name(device: Union[str, torch.device]) -> str:
    """The platform key of cost tables (``perf/tables/<platform>_tp<tp>``):
    ``"cpu"`` on the host; on a card, the first word of its lower-cased
    name, split at spaces and dashes, that is not a brand word (``"h100"`` for
    "NVIDIA H100 80GB HBM3", ``"a800"`` for "NVIDIA A800-SXM4-80GB",
    ``"4090"`` for "NVIDIA GeForce RTX 4090"), the names the performance
    model's profiles use."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    name = torch.cuda.get_device_name(dev).lower()
    words = [w for w in name.replace("-", " ").split()
             if w not in _BRAND_WORDS]
    if not words:
        raise ValueError(f"no platform word in the card's name {name!r}")
    return words[0]
