"""The wire traffic of a step's collectives on each rank under ring
algorithms, from their payloads: a frozen copy of the port's
`tools/scaling_audit.wire_bytes_per_chip`, in the recorder's convention
(`parallel/collectives.record_collectives`: an all_gather's payload is the
rank's own rows, a reduce_scatter's the full buffer).

  all_reduce of S       2 S (n - 1) / n
  all_gather of S       S (n - 1)
  reduce_scatter of S   S (n - 1) / n
  anything else         S"""
from __future__ import annotations

from typing import Dict

OPS = ("all_reduce", "all_gather", "reduce_scatter")


def wire_bytes(payload: Dict[str, float], n: int) -> float:
    """Bytes each of n ranks moves for the summed payloads {op: bytes}."""
    total = 0.0
    for op, s in payload.items():
        if op == "all_reduce":
            total += 2.0 * s * (n - 1) / n
        elif op == "all_gather":
            total += s * (n - 1)
        elif op == "reduce_scatter":
            total += s * (n - 1) / n
        else:
            total += s
    return total
