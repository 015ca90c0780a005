"""The GPU's peak rates and memory, from its name: counterpart of
``ocpg_tpu/utils/hw.py``.

Every script that reports a roofline bound or a memory share takes the
card's figures from here, and records which card they assume, so a run on
another GPU reports that GPU's numbers instead of the H100's.

Figures are NVIDIA's data-sheet peaks for the H100 SXM (the card the port
targets; its device name is "NVIDIA H100 80GB HBM3"): dense bfloat16
tensor-core FLOP/s (no sparsity), float32 FLOP/s outside the tensor cores,
HBM bytes per second and memory.  Any other name, the PCIe and NVL H100s
included, takes the same figures with ``assumed=True`` so a caller can
flag the guess.
"""

from __future__ import annotations

from dataclasses import dataclass

# name substring (lower case) -> (bf16 FLOP/s, f32 FLOP/s, HBM B/s, memory bytes)
_SPECS = {
    "h100 80gb hbm3": (989e12, 67e12, 3.35e12, 80 * 1024**3),
}

_DEFAULT = "h100 80gb hbm3"


@dataclass(frozen=True)
class GpuSpec:
    kind: str                # the device name in lower case (or the fallback's)
    peak_flops_bf16: float   # dense bf16 tensor-core FLOP/s
    peak_flops_f32: float    # float32 FLOP/s outside the tensor cores
    hbm_bytes_per_s: float
    hbm_bytes: int
    assumed: bool            # True when the name was not recognised


def gpu_spec(device=None) -> GpuSpec:
    """Spec of ``device``: a device name (str), or a CUDA device or index
    whose ``torch.cuda.get_device_name`` is read (default: the current
    device).  Without a GPU it returns the fallback, so scripts stay
    runnable on the CPU."""
    if isinstance(device, str) and not device.startswith("cuda"):
        name = device
    else:
        import torch

        name = torch.cuda.get_device_name(device) if torch.cuda.is_available() else ""
    kind = name.lower()
    for sub, (bf16, f32, rate, mem) in _SPECS.items():
        if sub in kind:
            return GpuSpec(kind, bf16, f32, rate, int(mem), assumed=False)
    bf16, f32, rate, mem = _SPECS[_DEFAULT]
    return GpuSpec(kind or f"{_DEFAULT} (assumed)", bf16, f32, rate, int(mem), assumed=True)


def nvidia_smi_line() -> str:
    """The first GPU's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (for
    example "NVIDIA H100 80GB HBM3, 700.00 W"): a card may be set below its
    full power and then runs slower, so every number a script keeps stands
    beside this line.  Raises if nvidia-smi fails."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_record(device) -> dict:
    """Where a script ran, for its JSON record: ``platform`` the card's
    name and power limit (``nvidia_smi_line``) or ``"cpu"``, ``devices``
    ``torch.cuda.device_count()`` (0 on the CPU)."""
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "devices": 0}
    return {"platform": nvidia_smi_line(), "devices": torch.cuda.device_count()}
