"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W), and the card's own name and
power limit, which every result carries beside the shares of these peaks."""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,
    "fp8": 1979e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """``nvidia-smi``'s power limit of the cards (watts, one a card), or
    'unknown'."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return ",".join(x.strip() for x in out.splitlines() if x.strip())
