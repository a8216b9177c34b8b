"""A cost walker over aten ops: the port's dry-run profiler.

The port's counterpart of the reference's ``launch/hlo_cost.py``. The
reference walks a compiled step's optimized HLO text; the port has no HLO,
so the aten op stream takes its place. :class:`CostMode` is a
``TorchDispatchMode``: every aten op a function runs passes through it,
autograd's backward and remat's recomputation (``torch.utils.checkpoint``
runs the forward again inside the backward) included, and it accumulates

  * flops      — a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ...)
                 2·|out|·K; an elementwise op |out|, integer ALU ops of the
                 field arithmetic (bitwise ops, shifts, ``remainder``,
                 comparisons, ``where``, ``clamp``, conversions) included;
                 a reduction or scan |in|; each by class of work
                 (``hlo_analysis.PEAKS``);
  * HBM bytes  — the operands plus the outputs of every op, each tensor's
                 distinct elements once (a broadcast axis of stride 0 reads
                 nothing more), since eager ops are unfused as HLO's
                 top-level instructions are; a gather reads the rows it
                 takes; views and metadata ops cost nothing;
  * link bytes — copies between devices, by link (``hlo_analysis.LINK_BW``);
  * the peak   — the most bytes held at once by storages the walk made
                 (each storage once, freed when PyTorch frees it, autograd's
                 saved tensors included), beside the bytes of the storages
                 it read but did not make (the arguments): the counterpart
                 of the reference's ``memory_analysis``.

The hand-written kernels are ctypes calls that the dispatcher never sees.
Each entry point of ``kernels.ops`` hands its call to the active walker
(``ops.walker``), which prices the kernel once from its operands' shapes,
with the bound formula of its row in ``PERF.md`` §6, and then runs it
unpriced: the same price whether the CUDA kernel launched or the plain
version stood in (on the CPU or on meta), and never the plain version's
ops as well.

An op that falls in no class is listed in ``Cost.unpriced`` with its
count, never dropped silently. :func:`analyze` runs one function under the
walker; the numbers are one device's, as the reference's are.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import ops as kops
from ..kernels import ss_matmul as _ssm
from .hlo_analysis import LINK_BW, Roofline, link_of

_FLOAT_TYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

#: ops that cost nothing: aliases, metadata and allocation without a write
_FREE = {
    "detach", "alias", "lift_fresh", "_unsafe_view", "view", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "resize", "set", "record_stream", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_pin_memory",
    "is_pinned", "_has_compatible_shallow_copy_type",
}

#: matrix products -> the operand that carries the contracted axis K last
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1, "addbmm": 1,
         "mv": 0, "addmv": 1, "dot": 0, "vdot": 0, "_int_mm": 0}

#: reductions and scans: |in| operations
_REDUCE = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "any", "all", "logsumexp", "norm", "linalg_vector_norm", "var", "std",
    "var_mean", "std_mean", "cumsum", "cumprod", "logcumsumexp", "cummax",
    "cummin", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nonzero", "count_nonzero", "equal",
    "native_layer_norm", "native_layer_norm_backward", "_fused_rms_norm",
    "_fused_rms_norm_backward", "aminmax", "mode", "median", "nansum",
}

#: elementwise ops that carry no ``pointwise`` tag: |out| operations
_ELEMENTWISE = {"_to_copy", "clamp", "clamp_min", "clamp_max", "where",
                "masked_fill", "tril", "triu", "bitwise_not", "logical_not",
                "fill_diagonal", "_masked_scale", "native_dropout",
                "native_dropout_backward", "embedding_dense_backward",
                "isin", "bucketize", "searchsorted", "softplus_backward",
                "logit_backward", "hardtanh_backward", "elu_backward"}

#: sorts: n·log2(n) operations
_SORT = {"sort", "argsort", "topk", "kthvalue", "msort"}

#: reads of rows: the rows taken are read and written once
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding",
           "take", "masked_select"}

#: writes into rows of a tensor: the update is read and written once
_SCATTER = {"index_put", "_index_put_impl", "index_add", "scatter",
            "scatter_add", "scatter_reduce", "index_copy", "index_fill",
            "masked_scatter", "index_reduce"}

#: data made or moved without arithmetic: operands and outputs
_MOVE = {"clone", "copy", "cat", "stack", "constant_pad_nd", "flip",
         "roll", "repeat", "repeat_interleave", "slice_scatter",
         "select_scatter", "diagonal_scatter", "as_strided_scatter",
         "lift_fresh_copy", "unfold_backward", "select_backward",
         "slice_backward", "index_select_backward"}

#: tensors made from nothing: their outputs are written once
_FILL = {"zeros", "ones", "full", "fill", "zero", "zeros_like", "ones_like",
         "full_like", "new_zeros", "new_ones", "new_full", "arange",
         "scalar_tensor", "linspace", "logspace", "randint", "randn", "rand",
         "randn_like", "rand_like", "randint_like", "normal", "uniform",
         "random", "bernoulli", "randperm", "eye", "exponential",
         "geometric", "cauchy", "log_normal"}


def _op_name(func) -> str:
    """``aten.add_.Tensor`` -> ``add``: in-place and functional forms
    price alike (dunder names such as ``__rshift__`` keep their form)."""
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]
    return name


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def distinct_numel(t: torch.Tensor) -> int:
    """Elements a read of ``t`` must touch: an axis of stride 0 (a
    broadcast) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0 or size == 0:
            n *= size
    return n


def nbytes(t: Optional[torch.Tensor]) -> int:
    """Distinct bytes of ``t`` (0 for ``None``)."""
    return 0 if t is None else distinct_numel(t) * t.element_size()


def _is_float(ts) -> bool:
    return any(t.dtype in _FLOAT_TYPES or t.is_complex() for t in ts)


def dot_class(dtype: torch.dtype) -> str:
    """The class of a matrix product of ``dtype`` operands on the card."""
    if dtype in (torch.bfloat16, torch.float16):
        return "dot_bf16"
    if dtype == torch.float32:
        return ("dot_tf32" if torch.backends.cuda.matmul.allow_tf32
                else "dot_f32")
    if dtype == torch.float64:
        return "dot_f64"
    return "dot_int"


# ---------------------------------------------------------------------------
# the hand-written kernels, priced by their PERF.md §6 bound formulas
# ---------------------------------------------------------------------------

#: operations a lane of one SS-SUB bit step costs (a mod-p multiply counts
#: 2): the LSB step 5 add/sub and 1 multiply, a carried step 8 and 2.
RIPPLE_INIT_OPS, RIPPLE_STEP_OPS = 7, 12


def _price_ss_matmul(a, b):
    batch, m, k, n = _ssm._shapes(a, b)
    name = "ss_matmul_tall" if _ssm.is_tall_skinny(m, k, n) else "ss_matmul"
    return (name, nbytes(a) + nbytes(b) + 4 * batch * m * n,
            32 * batch * m * k * n, "int8")


def _price_match(col, pat):
    c, b, n, w, a = col.shape
    return ("aa_match_batch", nbytes(col) + nbytes(pat) + 4 * c * b * n,
            b * (2 * c * n * w * a + c * n * (w - 1)), "int")


def _rows_read(rel, lengths) -> Tuple[int, int]:
    """-> (tuples read over the row blocks, bytes a tuple's word)."""
    c, _, _, w, a = rel.shape
    return int(sum(lengths)), c * w * a * rel.element_size()


def _price_match_rows(rel, columns, starts, lengths, pat, height):
    c, _, _, w, a = rel.shape
    rows, row_bytes = _rows_read(rel, lengths)
    return ("aa_match_batch",
            rows * row_bytes + nbytes(pat) + 4 * c * len(columns) * height,
            2 * c * rows * w * a + c * rows * (w - 1), "int")


def _price_slide(col, pat):
    c, b, n, w, a = col.shape
    k = pat.shape[2]
    m = w - k + 1
    return ("aa_slide_batch",
            nbytes(col) + nbytes(pat) + 4 * c * b * n * m,
            b * (2 * c * n * m * k * a + c * n * m * (k - 1)), "int")


def _price_slide_rows(rel, columns, starts, lengths, pat, height):
    c, _, _, w, a = rel.shape
    k = pat.shape[2]
    m = w - k + 1
    rows, row_bytes = _rows_read(rel, lengths)
    return ("aa_slide_batch",
            rows * row_bytes + nbytes(pat) + 4 * c * len(columns) * height * m,
            2 * c * rows * m * k * a + c * rows * m * (k - 1), "int")


def _price_ripple(a, b, carry=None):
    k = a.shape[-1]
    lanes = a.numel() // max(k, 1)
    nops = lanes * (k * RIPPLE_STEP_OPS if carry is not None
                    else RIPPLE_INIT_OPS + (k - 1) * RIPPLE_STEP_OPS)
    return ("ripple_carry" if k == 1 else "ripple_segment",
            nbytes(a) + nbytes(b) + nbytes(carry) + 2 * 4 * lanes, nops,
            "int")


def _price_onehot(tokens, a1, *, n_shares):
    m, v = a1.shape
    return ("share_onehot",
            nbytes(a1) + nbytes(tokens) + 4 * n_shares * m * v,
            (n_shares + 1) * m * v, "int")


#: entry point of ``kernels.ops`` -> its price: (the launch counter's
#: name, bytes, operations, class of the operations)
KERNEL_PRICES: Dict[str, Callable[..., Tuple[str, int, int, str]]] = {
    "ss_matmul": _price_ss_matmul,
    "aa_match_batch": _price_match,
    "aa_match_rows": _price_match_rows,
    "aa_slide_batch": _price_slide,
    "aa_slide_rows": _price_slide_rows,
    "ripple_segment": _price_ripple,
    "share_onehot": _price_onehot,
}



# ---------------------------------------------------------------------------
# the walker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in LINK_BW})
    flops_by_class: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    unpriced: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0                 # aten ops priced
    host_ops: int = 0            # ops left to the host (``device=``)
    arg_bytes: float = 0.0       # storages read that the walk did not make
    peak_bytes: float = 0.0      # most bytes live in storages it made

    def add_flops(self, cls: str, n: float) -> None:
        self.flops += n
        self.flops_by_class[cls] = self.flops_by_class.get(cls, 0.0) + n

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.hbm_bytes += other.hbm_bytes
        self.ops += other.ops
        self.host_ops += other.host_ops
        for mine, theirs in ((self.collectives, other.collectives),
                             (self.flops_by_class, other.flops_by_class),
                             (self.kernels, other.kernels),
                             (self.unpriced, other.unpriced),
                             (self.op_counts, other.op_counts)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v
        self.arg_bytes = max(self.arg_bytes, other.arg_bytes)
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        return self

    def scaled(self, mult: float) -> "Cost":
        """The work of ``mult`` runs one after another (a loop body times
        its trip count); the peak and the arguments stay one run's."""
        def times(d):
            return {k: v * mult for k, v in d.items()}
        return Cost(self.flops * mult, self.hbm_bytes * mult,
                    times(self.collectives), times(self.flops_by_class),
                    times(self.kernels), times(self.unpriced),
                    times(self.op_counts), int(self.ops * mult),
                    int(self.host_ops * mult), self.arg_bytes,
                    self.peak_bytes)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def roofline(self, n_chips: int = 1,
                 peak_memory: Optional[float] = None) -> Roofline:
        """The walk's terms at the H100's peaks; the peak memory defaults
        to the arguments plus the walk's own peak."""
        return Roofline(
            flops=self.flops, bytes_accessed=self.hbm_bytes,
            collective_bytes=self.collective_bytes, n_chips=n_chips,
            collective_detail=dict(self.collectives),
            peak_memory_per_device=(self.arg_bytes + self.peak_bytes
                                    if peak_memory is None else peak_memory),
            flops_by_class=dict(self.flops_by_class))


class CostMode(TorchDispatchMode):
    """Accumulates the :class:`Cost` of every aten op and kernel call run
    while it is entered. ``device`` (a device type such as ``"cuda"``)
    leaves ops whose tensors all lie elsewhere to the host: they are
    counted in ``host_ops`` and not priced."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.cost = Cost()
        self.device = device
        self._quiet = 0
        self._prev = None
        self._live: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self._live_bytes = 0

    def __enter__(self):
        self._prev, kops.walker = kops.walker, self
        return super().__enter__()

    def __exit__(self, *exc):
        kops.walker = self._prev
        return super().__exit__(*exc)

    # -- memory ---------------------------------------------------------
    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _note(self, inputs, outputs) -> None:
        """Storages first seen as inputs are arguments; storages first
        seen as outputs were made by the walk and live until freed."""
        for t in inputs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._live and key not in self._args:
                self._args[key] = st.nbytes()
                self.cost.arg_bytes += st.nbytes()
                weakref.finalize(st, self._args.pop, key, None)
        for t in outputs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._args:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
            self.cost.peak_bytes = max(self.cost.peak_bytes,
                                       self._live_bytes)

    # -- kernels --------------------------------------------------------
    def kernel(self, entry: Callable, *args, **kw):
        """Price one call of the ``kernels.ops`` entry point ``entry`` by
        its formula, then run it unpriced."""
        name, nb, nops, cls = KERNEL_PRICES[entry.__name__](*args, **kw)
        cost = self.cost
        cost.kernels[name] = cost.kernels.get(name, 0) + 1
        cost.hbm_bytes += nb
        cost.add_flops(cls, nops)
        kops.walker = None
        self._quiet += 1
        try:
            out = entry(*args, **kw)
        finally:
            self._quiet -= 1
            kops.walker = self
        self._note(_tensors((args, kw)), _tensors(out))
        return out

    # -- aten ops -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + outs):
            self.cost.host_ops += 1
            return out
        name = _op_name(func)
        if not (name in _FREE or _is_view(func)):
            cost = self.cost
            if self._price(name, func, args, kwargs, ins, outs):
                cost.ops += 1
                cost.op_counts[name] = cost.op_counts.get(name, 0) + 1
            else:
                key = str(func.overloadpacket)
                cost.unpriced[key] = cost.unpriced.get(key, 0) + 1
        self._note(ins, outs)
        return out

    def _price(self, name, func, args, kwargs, ins, outs) -> bool:
        """Add one op's work to the cost; False for an op in no class."""
        cost = self.cost
        if name in ("_to_copy", "copy") and self._crossing(name, args,
                                                           kwargs):
            return True
        if name == "_local_scalar_dense":
            link = link_of(ins[0].device, "cpu")
            if link is not None:
                cost.collectives[link] += ins[0].element_size()
            return True
        io = sum(nbytes(t) for t in ins) + sum(nbytes(t) for t in outs)
        out_n = sum(t.numel() for t in outs)
        kind = "float" if _is_float(ins + outs) else "int"
        if name in _DOTS:
            lhs = ins[_DOTS[name]]
            k = lhs.numel() if name in ("dot", "vdot") else lhs.shape[-1]
            if name == "addbmm":
                k *= lhs.shape[0]
            cost.add_flops(dot_class(lhs.dtype), 2.0 * out_n * k)
            cost.hbm_bytes += io
        elif name in _GATHER:
            idx = sum(nbytes(t) for t in ins[1:])
            cost.hbm_bytes += 2 * sum(nbytes(t) for t in outs) + idx
        elif name in _SCATTER:
            upd = sum(nbytes(t) for t in ins[1:])
            whole = 0 if func._schema.is_mutable else (
                nbytes(ins[0]) + sum(nbytes(t) for t in outs))
            cost.hbm_bytes += 2 * upd + whole
        elif name in _MOVE:
            if name == "copy" and ins[0].dtype != ins[1].dtype:
                cost.add_flops(kind, out_n)
            cost.hbm_bytes += io
        elif name in _FILL:
            cost.hbm_bytes += sum(nbytes(t) for t in outs)
        elif name in _SORT:
            n_in = ins[0].numel()
            cost.add_flops(kind, n_in * max(1.0, math.log2(max(n_in, 2))))
            cost.hbm_bytes += io
        elif name in _REDUCE or torch.Tag.reduction in func.tags:
            cost.add_flops(kind, sum(t.numel() for t in ins[:1]) or out_n)
            cost.hbm_bytes += io
        elif name in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
            cost.add_flops(kind, out_n)
            cost.hbm_bytes += io
        else:
            return False
        return True

    def _crossing(self, name, args, kwargs) -> bool:
        """Price a copy between devices on its link; False for a copy on
        one device."""
        if name == "copy":
            dst, src = args[0], args[1]
            dst_dev, src_dev = dst.device, src.device
        else:
            src = args[0]
            src_dev = src.device
            dst_dev = torch.device(kwargs.get("device") or src_dev)
        if _same_device(src_dev, dst_dev):
            return False
        link = link_of(src_dev, dst_dev)
        if link is not None:
            self.cost.collectives[link] += nbytes(src)
            self.cost.hbm_bytes += nbytes(src)
        return True


def _same_device(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    return (a.index or 0) == (b.index or 0)


def analyze(fn: Callable, *args, **kw) -> Cost:
    """Run ``fn(*args, **kw)`` under a walker -> its :class:`Cost`."""
    with CostMode() as mode:
        fn(*args, **kw)
    return mode.cost
