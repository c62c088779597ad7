"""Device choice for the port's entry points."""

from __future__ import annotations

import argparse

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA (or asking for nothing) where no CUDA device
    is present raises; nothing moves to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    """`--device` (default: CUDA through `resolve_device`), also spelt
    `--platform` as in the JAX package's scripts."""
    parser.add_argument("--device", "--platform", dest="device", default=None,
                        help="torch device (default: cuda; --platform cpu is the JAX spelling)")
