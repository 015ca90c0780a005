"""The few calls that differ between the card and the CPU (on which the
benchmark's own tests drive a run at a tiny size)."""

from __future__ import annotations

import gc

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def synchronize(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if is_cuda(device) else 0


def reset_peak(device) -> None:
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats()


def free(device) -> None:
    gc.collect()
    if is_cuda(device):
        torch.cuda.empty_cache()


def float32_proper(device) -> None:
    """Matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
