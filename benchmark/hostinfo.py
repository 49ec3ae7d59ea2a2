"""The card's and the host's description, printed beside every result:
the card's name, clocks and power limit from ``nvidia-smi``, and the
host's CPU model."""

from __future__ import annotations

import subprocess

_QUERY = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={_QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return f"{_QUERY}: " + "; ".join(out.stdout.strip().splitlines())


def cpu() -> str:
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if ":" in line:
                    k, v = (s.strip() for s in line.split(":", 1))
                    fields.setdefault(k, v)
                    if k == "processor":
                        fields["cpus"] = str(int(v) + 1)
    except OSError:
        return "unknown"
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = ("{} family {} model {}".format(
            fields.get("vendor_id", "?"), fields.get("cpu family", "?"),
            fields.get("model", "?")))
    return f"{name}, {fields.get('cpus', '?')} CPUs at {fields.get('cpu MHz', '?')} MHz"
