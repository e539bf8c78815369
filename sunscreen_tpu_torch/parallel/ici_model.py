"""Collective-byte accounting and an analytic link model (port of
`sunscreen_tpu/parallel/ici_model.py`).

1. `collective_stats()` reads the bytes and calls that the mesh helpers'
   collectives counted over one block of code (`mesh.COUNTERS`): the
   volumes the sharded code actually exchanged. The reference parses
   them out of XLA's compiled HLO instead.
2. `predict_efficiency(...)` combines those volumes with a link
   bandwidth and a measured one-device step time. The bandwidth is an
   argument: this module states no hardware figure.

Cost per collective of V bytes over an axis of size d (ring algorithms,
bidirectional links, the standard reduced forms), where V is the full
(unsharded) array size and W the one-way bandwidth of a device's link
along the axis:
  all-gather / reduce-scatter: (d-1)/d * V / W
  all-reduce:                  2 * (d-1)/d * V / W
  collective-permute:          V / W
  all-to-all:                  (d-1)/d * V / W / 4 (bisection form)
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from sunscreen_tpu_torch.parallel.mesh import COUNTERS


@dataclass
class CollectiveStats:
    """Per-kind collective volumes: bytes[kind] is the sum of the full
    array bytes of every collective of that kind (the V of the forms
    above), count[kind] their number."""

    bytes: dict = field(default_factory=dict)
    count: dict = field(default_factory=dict)

    def total_bytes(self) -> int:
        return sum(self.bytes.values())

    def link_seconds(self, axis_size: int, link_bytes_per_s: float) -> float:
        """Ring-model link time of these volumes over one mesh axis of
        `axis_size` devices at `link_bytes_per_s` one way."""
        w = link_bytes_per_s
        d = max(axis_size, 1)
        t = 0.0
        for kind, v in self.bytes.items():
            if d == 1:
                continue
            if kind == "all-reduce":
                t += 2 * (d - 1) / d * v / w
            elif kind in ("all-gather", "reduce-scatter"):
                t += (d - 1) / d * v / w
            elif kind == "collective-permute":
                t += v / w
            elif kind == "all-to-all":
                t += (d - 1) / d * v / w / 4
        return t


@contextlib.contextmanager
def collective_stats():
    """`with collective_stats() as st: fn(...)` leaves in `st` the
    collectives that the mesh helpers ran in the block, on this rank."""
    before = {kind: list(v) for kind, v in COUNTERS.items()}
    st = CollectiveStats()
    try:
        yield st
    finally:
        for kind, (nbytes, count) in COUNTERS.items():
            b0, c0 = before.get(kind, (0, 0))
            if count > c0:
                st.bytes[kind] = nbytes - b0
                st.count[kind] = count - c0


def predict_efficiency(single_step_s: float, coll: CollectiveStats,
                       axis_size: int, link_bytes_per_s: float,
                       overlap: float = 0.0) -> float:
    """Predicted scaling efficiency of a per-device-constant workload
    (weak scaling: each device keeps the one-device workload, and the
    axis of size `axis_size` adds the counted collective volumes):

      eff = t_comp / (t_comp + (1 - overlap) t_link)

    `overlap` in [0, 1] models compute/communication overlap (0, fully
    exposed, is the conservative default)."""
    t_link = coll.link_seconds(axis_size, link_bytes_per_s) * (1 - overlap)
    return single_step_s / (single_step_s + t_link)
