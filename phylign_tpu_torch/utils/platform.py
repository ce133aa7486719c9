"""Device resolution for the port.

The port never changes device on its own: asking for ``cuda`` on a host
without a usable CUDA device raises instead of quietly running on the CPU,
so a CPU run can never be recorded as a GPU one.
"""

from __future__ import annotations

import subprocess

import torch


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch device for ``name``; raises when CUDA is asked for and
    ``torch.cuda.is_available()`` is False."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but torch.cuda.is_available() "
            "is False (pass device='cpu' to run the plain PyTorch path)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev


def gpu_label() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card). Every time this port reports is
    labelled with it: a card set below its maximum power runs slower."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
