"""Published peaks of the cards the benchmark runs on.

NVIDIA's H100 SXM data sheet (80 GB HBM3): 3.35 TB/s of memory
bandwidth at the 700 W power limit.  A card set to a lower limit runs
slower under load: the run reports the limit beside the numbers.
"""
import subprocess

PEAKS = {"H100": {"hbm_bytes_per_s": 3.35e12}}


def peaks(device_name: str):
    """The peak table of the card named ``device_name``, or None."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None


def power_limit_w():
    """The first card's power limit in watts (``nvidia-smi``), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
