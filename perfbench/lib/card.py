"""The card's name and power limit, as nvidia-smi reads them."""

import subprocess


def line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (out.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]
