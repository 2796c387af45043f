"""What the benchmark tools share: the device they run on and the card's
name and power limit, printed beside every time they report."""
from __future__ import annotations

import subprocess

import torch

CPU_LABEL = "cpu (rehearsal: no device number is measured)"


def device_and_card(device="cuda"):
    """(torch.device, label). A CUDA device needs a card: this raises rather
    than going on on the CPU. The label of a card is
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, CPU_LABEL
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for {device!r}; pass --device cpu to rehearse on "
                           "the CPU")
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return dev, out.strip().splitlines()[index]


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
