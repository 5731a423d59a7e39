"""Process + device memory usage reporting.

Reference analogue: CProcessMemInfo (reference include/slam/MemUsage.h:54)
— current/peak working set queries printed in verbose mode — extended with
the device half: per-device memory usage via jax's memory_stats().
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def process_memory() -> Dict[str, int]:
    """Current and peak RSS in bytes (Linux /proc; the reference reads the
    same counters through GetProcessMemoryInfo/getrusage)."""
    out = {"rss": 0, "peak_rss": 0}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    out["peak_rss"] = int(line.split()[1]) * 1024
    except OSError:
        try:
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF)
            out["peak_rss"] = ru.ru_maxrss * 1024
        except Exception:
            pass
    return out


def device_memory() -> Dict[str, Dict[str, int]]:
    """Per-device memory stats (bytes) where the backend reports them."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": int(stats.get("bytes_in_use", 0)),
                "peak_bytes_in_use": int(stats.get("peak_bytes_in_use", 0)),
                "bytes_limit": int(stats.get("bytes_limit", 0)),
            }
    return out


def format_report(prefix: str = "memory") -> str:
    """One-line human-readable report (the reference's verbose print)."""
    pm = process_memory()

    def mb(x):
        return f"{x / (1 << 20):.1f} MB"

    parts = [f"{prefix}: host rss {mb(pm['rss'])} "
             f"(peak {mb(pm['peak_rss'])})"]
    for dev, st in device_memory().items():
        parts.append(f"{dev}: {mb(st['bytes_in_use'])} in use "
                     f"(peak {mb(st['peak_bytes_in_use'])}"
                     + (f", limit {mb(st['bytes_limit'])}" if
                        st["bytes_limit"] else "") + ")")
    return "; ".join(parts)
