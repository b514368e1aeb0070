"""The card's name and power limit, which every time read on it carries:
a card set below its maximum power runs slower under load."""

import subprocess


def name_and_power():
    """The first card's line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader``, e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
