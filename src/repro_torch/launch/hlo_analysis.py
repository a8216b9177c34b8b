"""Roofline terms of a step on one NVIDIA H100.

The port's counterpart of the reference's ``launch/hlo_analysis.py``. The
reference reads its terms from a compiled XLA module; the port has no HLO,
so the aten op stream takes its place: ``launch.hlo_cost`` walks the ops a
step runs (and prices each hand-written kernel once, from its operands'
shapes) and hands the totals to :class:`Roofline`, which divides each by
the card's peak.

Hardware model (NVIDIA's data sheet, H100 SXM, dense rates at the full
700 W power limit): 3.35 TB/s of HBM; the tensor cores at 989 TFLOP/s in
bf16 and fp16, 495 in TF32 and 1,979 TOP/s in int8; 67 TFLOP/s in float32
outside the tensor cores; 450 GB/s each way between two cards of a host
(NVLink) and 64 GB/s each way between the host and a card (PCIe Gen5 x16).
A card set below 700 W runs slower under load: the terms are a bound, not
a prediction.

The reference's ``collective_bytes(hlo_text)``, ``_shape_bytes`` and
``analyze(compiled, n_chips)`` read HLO text and XLA's compiled object and
have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

HBM_BW = 3.35e12            # B/s, one card
NVLINK_BW = 450e9           # B/s each way, card to card
PCIE_BW = 64e9              # B/s each way, host to card

#: peak operations a second by class of work. ``dot_*`` are matrix
#: products by operand type; ``int8`` is the two hand-written matmul
#: kernels' tensor-core work (32 int8 operations a modular multiply-add);
#: ``float`` and ``int`` are elementwise and reduction work outside the
#: tensor cores, ``int`` also the integer kernels' ALU work (64 INT32 lanes
#: an SM, half the float32 rate).
PEAKS: Dict[str, float] = {
    "dot_bf16": 989e12,      # bf16 and fp16 tensor cores
    "dot_tf32": 495e12,      # float32 dots with TF32 allowed
    "dot_f32": 67e12,        # float32 dots without TF32
    # H100 SXM FP64 tensor-core rate (NVIDIA H100 data sheet): the plain
    # field.matmul runs its 16-bit limb dots in float64 on the card.
    "dot_f64": 67e12,
    "dot_int": 33.5e12,      # integer matmul (CPU only: CUDA has none)
    "int8": 1.979e15,
    "float": 67e12,
    "int": 33.5e12,
}

#: the class that flops without a breakdown count in: the reference's
#: single ``PEAK_FLOPS`` is its bf16 matrix rate.
DEFAULT_CLASS = "dot_bf16"

#: link rates by the kind of copy that crosses them
LINK_BW: Dict[str, float] = {"nvlink": NVLINK_BW, "pcie": PCIE_BW}


def link_of(src, dst) -> Optional[str]:
    """The link a copy from device ``src`` to ``dst`` crosses: ``"nvlink"``
    between two cards, ``"pcie"`` between the host and a card, ``None`` on
    one device (or on meta, where nothing moves)."""
    kinds = {getattr(src, "type", str(src).split(":")[0]),
             getattr(dst, "type", str(dst).split(":")[0])}
    if "meta" in kinds or str(src) == str(dst):
        return None
    if kinds == {"cuda"}:
        return "nvlink"
    if "cuda" in kinds:
        return "pcie"
    return None


def copies_detail(copies, device_of) -> Dict[str, float]:
    """Link bytes from ``MeshDispatcher.copies()`` records: each record's
    bytes go to the link between ``device_of(src)`` and
    ``device_of(dst)`` (grid slots or ``"client"``)."""
    out = {k: 0.0 for k in LINK_BW}
    for rec in copies:
        link = link_of(device_of(rec["src"]), device_of(rec["dst"]))
        if link is not None:
            out[link] += rec["bytes"]
    return out


@dataclasses.dataclass
class Roofline:
    """One card's quantities, so each term divides by one card's peak
    (a grid's totals are per card x ``n_chips``)."""
    flops: float
    bytes_accessed: float
    collective_bytes: float
    n_chips: int
    collective_detail: Dict[str, float]
    peak_memory_per_device: Optional[float] = None
    flops_by_class: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        """Each class's work over its peak, summed; without a breakdown
        every flop at the bf16 matrix rate."""
        if not self.flops_by_class:
            return self.flops / PEAKS[DEFAULT_CLASS]
        return sum(v / PEAKS[k] for k, v in self.flops_by_class.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        """Each link's bytes over its rate; bytes the detail does not place
        on a link count at the NVLink rate."""
        placed = {k: self.collective_detail.get(k, 0.0) for k in LINK_BW}
        rest = max(0.0, self.collective_bytes - sum(placed.values()))
        return (sum(v / LINK_BW[k] for k, v in placed.items())
                + rest / NVLINK_BW)

    @property
    def t_bound(self) -> float:
        """The least time the card could take: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return dict(flops=self.flops, bytes_accessed=self.bytes_accessed,
                    collective_bytes=self.collective_bytes,
                    n_chips=self.n_chips,
                    t_compute=self.t_compute, t_memory=self.t_memory,
                    t_collective=self.t_collective, t_bound=self.t_bound,
                    bottleneck=self.bottleneck,
                    peak_memory_per_device=self.peak_memory_per_device,
                    flops_by_class=dict(self.flops_by_class or {}),
                    collective_detail=dict(self.collective_detail))
