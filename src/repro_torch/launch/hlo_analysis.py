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
(NVLink, ``CARDS_PER_HOST`` = 8 cards a host), 50 GB/s each way a card
between cards of different hosts (InfiniBand NDR, one 400 Gb/s port a
card) and 64 GB/s each way between the host and a card (PCIe Gen5 x16).
A card set below 700 W runs slower under load: the terms are a bound, not
a prediction.

On a mesh the walker prices one rank: each term is one card's, and a
grid's totals are ``n_chips`` times as much. A collective is recorded, as
the reference's ``collective_bytes`` sums them, by its output bytes and
kind (``COLLECTIVES``), on the link its group crosses (:func:`link_of_
ranks`): NVLink within one host, InfiniBand once the group spans hosts;
and by kind, group size and link (``collective_groups``). It is priced
(:func:`collective_seconds`) by the bytes NCCL moves through each rank's
link for its kind and group size n, its bus bytes (:func:`bus_factor`
times the output), at a bus rate by kind and group size measured on
NVLink (``NVLINK_BUS_BW``) or at ``IB_BW`` across hosts.
:func:`collective_bytes` and :func:`analyze` are the counterparts of the
reference's, over a walk instead of HLO text and XLA's compiled object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

HBM_BW = 3.35e12            # B/s, one card
NVLINK_BW = 450e9           # B/s each way, card to card within a host
IB_BW = 50e9                # B/s each way a card, between hosts
PCIE_BW = 64e9              # B/s each way, host to card
CARDS_PER_HOST = 8

#: the collective kinds: the reference's names, and ``reduce`` (partials
#: brought to one rank, ``MeshDispatcher``'s mod-p reductions)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "reduce")

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
LINK_BW: Dict[str, float] = {"nvlink": NVLINK_BW, "ib": IB_BW,
                             "pcie": PCIE_BW}

#: NCCL's bus bytes a second on NVLink by collective kind and group size:
#: NCCL's all-reduce, all-gather and reduce-scatter alone, 256 MiB of
#: output, on 2 and on 4 NVIDIA H100 80GB HBM3 of one host at a 700.00 W
#: power limit (``chip_smoke.py --grids``, ``grid_links``); each rate the
#: geometric mean of the lowest and highest bus rate measured at that
#: size (``PERF.md`` §6 lists the runs). The bus rate rises from 2 ranks
#: to 4 (an all-gather's 181-215 GB/s to 214-290), so no one rate a kind
#: holds both sizes within 25 %. A group takes the rate of the largest
#: size measured that is not larger than it (the smallest below that); a
#: kind not measured takes the all-gather's, the lowest.
NVLINK_BUS_BW: Dict[str, Dict[int, float]] = {
    "all-reduce": {2: 258e9, 4: 290e9},
    "all-gather": {2: 197e9, 4: 249e9},
    "reduce-scatter": {2: 225e9, 4: 312e9}}


def bus_rate(kind: str, n: int) -> float:
    """NCCL's bus bytes a second on NVLink for ``kind`` over ``n`` ranks
    (``NVLINK_BUS_BW``)."""
    rates = NVLINK_BUS_BW.get(kind, NVLINK_BUS_BW["all-gather"])
    sizes = [m for m in sorted(rates) if m <= n] or [min(rates)]
    return rates[sizes[-1]]


def bus_factor(kind: str, n: int) -> float:
    """NCCL's bus bytes through each rank's link per output byte of a
    collective of ``kind`` over ``n`` ranks: 2(n-1)/n for an all-reduce,
    (n-1)/n for an all-gather or an all-to-all, n-1 for a reduce-scatter
    (whose output is 1/n of its input), 1 for the others; 0 for one
    rank."""
    if n <= 1:
        return 0.0
    return {"all-reduce": 2.0 * (n - 1) / n, "all-gather": (n - 1) / n,
            "all-to-all": (n - 1) / n,
            "reduce-scatter": float(n - 1)}.get(kind, 1.0)


def collective_seconds(kind: str, n: int, nbytes: float, link: str
                       ) -> float:
    """The least time a collective of ``kind`` over ``n`` ranks with
    ``nbytes`` of output takes on ``link``: its bus bytes at the link's
    bus rate (:func:`bus_rate` on NVLink, the link's rate elsewhere).
    ``reduce``, ``MeshDispatcher``'s partials copied between slots and
    not an NCCL call, moves its bytes at the link's rate."""
    rate = (bus_rate(kind, n) if link == "nvlink" and kind != "reduce"
            else LINK_BW[link])
    return bus_factor(kind, n) * nbytes / rate


def group_key(kind: str, n: int, link: str) -> str:
    """A ``collective_groups`` key (a string, so a record is JSON): kind,
    group size and link; :func:`split_key` reads it back."""
    return f"{kind}|{n}|{link}"


def split_key(key: str) -> Tuple[str, int, str]:
    """A :func:`group_key`'s kind, group size and link."""
    kind, n, link = key.split("|")
    return kind, int(n), link


def bytes_by(groups: Dict[str, float], part: int) -> Dict[str, float]:
    """``collective_groups``' output bytes summed by one part of the key:
    0 the kind, 1 the group size, 2 the link."""
    out: Dict = {}
    for key, nb in groups.items():
        k = split_key(key)[part]
        out[k] = out.get(k, 0.0) + nb
    return out


def seconds_by_kind(groups: Dict[str, float]) -> Dict[str, float]:
    """``collective_groups``' collectives priced
    (:func:`collective_seconds`), summed by kind."""
    out: Dict[str, float] = {}
    for key, nb in groups.items():
        kind, n, link = split_key(key)
        out[kind] = out.get(kind, 0.0) + collective_seconds(kind, n, nb,
                                                             link)
    return out


def link_of_ranks(ranks) -> Optional[str]:
    """The link a collective over the global ``ranks`` crosses (one card a
    rank, ``CARDS_PER_HOST`` consecutive ranks a host): ``"nvlink"``
    within one host, ``"ib"`` across hosts, ``None`` for one rank."""
    ranks = list(ranks)
    if len(ranks) <= 1:
        return None
    hosts = {r // CARDS_PER_HOST for r in ranks}
    return "nvlink" if len(hosts) == 1 else "ib"


def collective_bytes(cost) -> Dict[str, float]:
    """A walk's collective output bytes by kind (``COLLECTIVES``), with
    ``count`` and ``total``, as the reference's ``collective_bytes`` sums
    them from HLO text; ``cost`` is an ``hlo_cost.Cost``."""
    out = {k: float(cost.collective_kinds.get(k, 0.0)) for k in COLLECTIVES}
    out["count"] = int(cost.collective_count)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


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
    collective_kinds: Optional[Dict[str, float]] = None
    collective_groups: Optional[Dict[str, float]] = None

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
        """Each collective of ``collective_groups`` at its bus bytes and
        rate (:func:`seconds_by_kind`); the bytes of ``collective_detail``
        that no group holds (copies between devices: a Roofline built by
        hand, as from ``copies_detail``, holds only these) over their
        link's rate, and bytes the detail does not place on a link at the
        NVLink rate."""
        groups = self.collective_groups or {}
        grouped = bytes_by(groups, 2)
        placed = {k: self.collective_detail.get(k, 0.0) for k in LINK_BW}
        rest = max(0.0, self.collective_bytes - sum(placed.values()))
        copies = sum(max(v - grouped.get(k, 0.0), 0.0) / LINK_BW[k]
                     for k, v in placed.items())
        return sum(seconds_by_kind(groups).values()) + copies + \
            rest / NVLINK_BW

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
                    collective_detail=dict(self.collective_detail),
                    collective_kinds=dict(self.collective_kinds or {}),
                    collective_groups=dict(self.collective_groups or {}))


def analyze(fn, *args, n_chips: Optional[int] = None, **kw) -> Roofline:
    """Walk ``fn(*args, **kw)`` (``hlo_cost.CostMode``) -> one rank's
    ``Roofline`` at ``n_chips`` ranks (default: the process group's world,
    1 without one), the counterpart of the reference's
    ``analyze(compiled, n_chips)``."""
    from . import hlo_cost
    if n_chips is None:
        import torch.distributed as dist
        n_chips = (dist.get_world_size() if dist.is_available()
                   and dist.is_initialized() else 1)
    return hlo_cost.analyze(fn, *args, **kw).roofline(n_chips=n_chips)
