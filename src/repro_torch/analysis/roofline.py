"""Three-term roofline of one step of the port, counted from its ATen ops.

Port of ``repro/analysis/roofline.py`` for an NVIDIA H100 SXM.  JAX reads
XLA's ``cost_analysis()`` of a compiled program and parses its HLO for
collectives; the port runs eagerly and has no compiler to ask, so it counts
the step itself: :func:`counting` records every ATen op a call runs (a
``TorchDispatchMode``), on the card or on ``"meta"``, where the dry run
(``launch/dryrun.py``) runs a full-size step with no memory and no data.

The card's peaks ("NVIDIA H100 80GB HBM3, 700 W"; NVIDIA's data sheet, SXM
part, dense) are the constants below.  The H100 has no single product rate:
fp32 products run ~15x slower than bf16 ones.  So ``compute_s`` sums each
dtype's product flops over that dtype's peak; ``flops`` stays JAX's single
total.  fp32 products take :data:`FP32_OPS_PER_S` (the port runs with
``allow_tf32`` off), fp64 ones (the card's exact integer scans on
``"matmul"``, ``core/precision.py`` ``_mm``) :data:`FP64_OPS_PER_S`.

What is counted, op by op:

* **Product flops**: ``torch.utils.flop_counter``'s registry (mm, addmm,
  bmm, baddbmm, convolution, and the einsum and matmul that decompose to
  them), keyed by the operands' dtype.  Elementwise work is not counted,
  as XLA's ``flops`` counts it but the roofline's compute term is the
  products.
* **Bytes**: each op's input tensors read once and its outputs written once
  (an input's distinct elements: a broadcast view reads its storage once).
  View and metadata ops, and allocations that write nothing (``empty``),
  cost nothing.  An indexed read (embedding, ``index_select``, ``gather``,
  ``index``) counts the elements it reads, not the whole table; an indexed
  or sliced write in place (``index_put_``, ``scatter_``, ``copy_`` into a
  slice) counts the elements it writes, not the tensor it writes into, and
  a destination that is only written is not read.  For an eager program
  this is the traffic it issues, short of L2 hits.  XLA's "bytes accessed"
  is a sum over fused HLO ops, which counts fusion-internal operands too
  (JAX's ``report.py`` ``derived_terms`` notes the double count); an eager
  op has no fusion, so each op's operands are real reads.
* **Kernels**: a hand-written kernel's launch passes ctypes pointers
  (``kernels/_build.py``), which no dispatch mode sees.  Each kernel wrapper
  records its own cost through ``_build.record``: its operands' bytes and
  its results' bytes, no flops (the bound of ``PERF.md``'s kernel table,
  and the port's counterpart of a Pallas ``cost_estimate``, which none of
  JAX's kernels gives).  On ``"meta"`` the wrapper returns its outputs
  unlaunched, so a meta step counts what the card runs.
* **Loops over time** (:func:`steps`): the sLSTM scan and the mLSTM prefill's
  state replay run one Python step a token.  Under a counter on ``"meta"``
  one step runs and its counts are multiplied by the steps (under autograd
  three, the middle one multiplied, forward and backward): every step is the
  same ops on the same shapes, so the rule is exact, and stepping through a
  loop of 32768 tokens a layer is not needed (XLA counts a while body once;
  JAX's dry run unrolls layers for that reason).

Collectives come from the calls the dry run models (``launch/dryrun.py``
``_collectives``: ``(kind, operand, bytes a device, group)``), with JAX's ring
factors by kind and group size; ``collective_s`` is their wire bytes over
NVLink.  A grid beyond one host's 8 cards crosses the network, which this
term does not model.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build

__all__ = ["BF16_OPS_PER_S", "TF32_OPS_PER_S", "FP32_OPS_PER_S", "FP64_OPS_PER_S",
           "INT8_OPS_PER_S", "HBM_BYTES_PER_S", "NVLINK_BYTES_PER_S", "PEAKS",
           "Count", "Roofline", "counting", "steps", "fill", "wire_bytes", "analyze",
           "model_flops", "bound"]

BF16_OPS_PER_S = 989e12        # H100 SXM bf16 / fp16 on the tensor cores, dense
TF32_OPS_PER_S = 495e12        # H100 SXM TF32 on the tensor cores, dense
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
FP64_OPS_PER_S = 67e12         # H100 SXM fp64 on the tensor cores
INT8_OPS_PER_S = 1979e12       # H100 SXM int8 on the tensor cores, dense
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
NVLINK_BYTES_PER_S = 450e9     # H100 SXM NVLink 4, each way

# product dtype -> the card's peak; a dtype not listed takes the fp32 rate
PEAKS = {"bfloat16": BF16_OPS_PER_S, "float16": BF16_OPS_PER_S,
         "float32": FP32_OPS_PER_S, "float64": FP64_OPS_PER_S,
         "int8": INT8_OPS_PER_S, "uint8": INT8_OPS_PER_S}

_aten = torch.ops.aten
# ops (by overload packet) that read and write nothing of the device's memory
_FREE = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
         _aten.new_empty_strided, _aten._unsafe_view, _aten.lift_fresh, _aten.set_,
         _aten.resize_, _aten.record_stream}
# in-place ops whose destination is written, not read
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.normal_, _aten.uniform_,
               _aten.random_, _aten.exponential_}
# indexed writes in place: the elements written are what is indexed
_INDEX_WRITES = {_aten.index_put_, _aten._index_put_impl_, _aten.scatter_,
                 _aten.scatter_add_, _aten.scatter_reduce_, _aten.index_copy_,
                 _aten.index_add_, _aten.index_fill_}
# indexed reads: the elements read of the first argument are the output's
_INDEX_READS = {_aten.embedding, _aten.index_select, _aten.gather, _aten.index}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a broadcast (stride-0) dim counts once."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) if t.dim() else 1
    return n * t.element_size() if t.numel() else 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _indexed_elements(self: torch.Tensor, indices) -> int:
    """Elements of ``self`` that ``self[indices]`` addresses (the indices
    broadcast together, then the dims they leave whole; a boolean mask, whose
    count the shapes do not give, the whole tensor)."""
    idx = [i for i in indices if i is not None]
    if idx and idx[0].dtype == torch.bool:
        return self.numel()
    shape = torch.broadcast_shapes(*(i.shape for i in idx)) if idx else ()
    return math.prod(shape) * math.prod(self.shape[len(indices):])


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes that one ATen op moves (module docstring)."""
    op = func._overloadpacket
    if op in _FREE or func.is_view:
        return 0
    if op in _WRITE_ONLY:
        dst = args[0]
        return _nbytes(dst) + sum(_distinct_bytes(t) for t in _tensors(args[1:]))
    if op in _INDEX_WRITES:
        # n elements written (and read too where the op accumulates), plus what
        # the indices and values read
        dst = args[0]
        if op in (_aten.index_put_, _aten._index_put_impl_):
            n = _indexed_elements(dst, args[1])
            accumulate = bool(args[3] if len(args) > 3 else kwargs.get("accumulate", False))
            reads = sum(_distinct_bytes(t) for t in _tensors(args[1]) + _tensors(args[2]))
        elif op is _aten.index_fill_:
            n = args[2].numel() * (dst.numel() // max(dst.shape[args[1]], 1))
            accumulate, reads = False, _distinct_bytes(args[2])
        else:           # index_copy_/index_add_(self, dim, index, src); scatter_*(same)
            index, src = args[2], args[3] if len(args) > 3 else None
            scatter = op not in (_aten.index_copy_, _aten.index_add_)
            n = index.numel() if scatter else src.numel()
            accumulate = op not in (_aten.index_copy_, _aten.scatter_)
            reads = _distinct_bytes(index)
            if isinstance(src, torch.Tensor):
                reads += n * src.element_size()
        return reads + n * dst.element_size() * (2 if accumulate else 1)
    if op in _INDEX_READS:
        table = args[0]
        res = _tensors(out)
        n = res[0].numel()
        idx = [t for t in _tensors(args[1:]) if t is not table]
        return (n * table.element_size() + sum(_distinct_bytes(t) for t in idx)
                + sum(_nbytes(t) for t in res))
    reads = sum(_distinct_bytes(t) for t in _tensors(args) + _tensors(list(kwargs.values())))
    return reads + sum(_nbytes(t) for t in _tensors(out))


# A functional op on "meta" tensors gives outputs whose shapes, strides and
# dtypes are a function of its inputs' and its other arguments alone, and so
# are its counts: a full-size step repeats each layer's ops on the same shapes,
# so the counter runs each distinct one once and builds the outputs of the
# rest with ``empty_strided`` (a meta kernel costs ~0.1 ms of Python).
_META_OPS: Dict[tuple, tuple] = {}


class _NoKey(Exception):
    pass


def _describe(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _NoKey
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_describe(v) for v in x)
    if isinstance(x, (int, float, bool, str, type(None), torch.dtype, torch.device,
                      torch.layout, torch.memory_format)):
        return type(x), x               # 2 and 2.0 give a product different dtypes
    raise _NoKey


@functools.lru_cache(maxsize=None)
def _functional(func) -> bool:
    """Whether ``func`` writes no argument and returns no alias of one."""
    schema = func._schema
    return not func.is_view and all(a.alias_info is None for a in schema.arguments) \
        and all(r.alias_info is None for r in schema.returns)


def _meta_key(func, args, kwargs):
    if not _functional(func):
        return None
    try:
        return (func, _describe(args), _describe(tuple(sorted(kwargs.items()))))
    except _NoKey:
        return None


def _layout(out):
    """The outputs' shapes, strides and dtypes, or None if not all meta tensors."""
    if isinstance(out, torch.Tensor):
        return ("T", tuple(out.shape), out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (list, tuple)):
        parts = [_layout(v) for v in out]
        return None if any(p is None for p in parts) else (type(out).__name__, *parts)
    return None


def _rebuild(layout):
    if layout[0] == "T":
        return torch.empty_strided(layout[1], layout[2], dtype=layout[3], device="meta")
    parts = [_rebuild(p) for p in layout[1:]]
    return parts if layout[0] == "list" else tuple(parts)


def _flops(func, args, kwargs, out) -> Optional[tuple]:
    """``(dtype name, product flops)`` of a registered product op, else None."""
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return None
    operand = next(t for t in _tensors(args) if t.dim() >= 2)
    args = tuple(a for a in args if not isinstance(a, torch.dtype))    # mm.dtype's out_dtype
    return str(operand.dtype).replace("torch.", ""), formula(*args, **kwargs, out_val=out)


@dataclasses.dataclass
class Count:
    """What a counted call ran: product flops by dtype, the ATen ops' bytes
    (``by_op``: each op's calls and bytes), and each kernel's recorded bytes and
    calls (``kernel_bytes`` their sum)."""
    flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    aten_bytes: float = 0.0
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    ops: int = 0
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def kernel_bytes(self) -> float:
        return float(sum(k["bytes"] for k in self.kernels.values()))

    @property
    def hbm_bytes(self) -> float:
        return self.aten_bytes + self.kernel_bytes

    def to_dict(self) -> Dict:
        return {"flops_by_dtype": dict(self.flops_by_dtype), "aten_bytes": self.aten_bytes,
                "kernel_bytes": self.kernel_bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()}, "ops": self.ops}


class _Counter(TorchDispatchMode):
    def __init__(self, count: Count):
        super().__init__()
        self.count, self.scale = count, 1
        self.ranges: List[tuple] = []       # (first, end, factor) of autograd nodes

    def factor(self) -> int:
        """The multiplier of what runs now: the forward's, times a loop step's in
        the backward of the autograd nodes that step made (:func:`steps`)."""
        k = self.scale
        if self.ranges:
            node = torch._C._current_autograd_node()
            if node is not None:
                nr = node._sequence_nr()
                for first, end, f in self.ranges:
                    if first <= nr < end:
                        k *= f
        return k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = _meta_key(func, args, kwargs)
        hit = _META_OPS.get(key) if key is not None else None
        if hit is None:
            out = func(*args, **kwargs)
            hit = (_flops(func, args, kwargs, out), _op_bytes(func, args, kwargs, out),
                   _layout(out))
            if key is not None and hit[2] is not None:
                _META_OPS[key] = hit
        else:
            out = _rebuild(hit[2])
        f, nbytes, _ = hit
        c, k = self.count, self.factor()
        c.ops += k
        if f is not None:
            c.flops_by_dtype[f[0]] = c.flops_by_dtype.get(f[0], 0.0) + k * f[1]
        c.aten_bytes += k * nbytes
        op = c.by_op.setdefault(func.__name__, [0, 0.0])
        op[0] += k
        op[1] += k * nbytes
        return out

    def kernel(self, name: str, nbytes: int) -> None:
        k = self.factor()
        rec = self.count.kernels.setdefault(name, {"calls": 0, "bytes": 0.0})
        rec["calls"] += k
        rec["bytes"] += k * nbytes


_ACTIVE: List[_Counter] = []


@contextlib.contextmanager
def counting():
    """Count what the calls inside run; yields the :class:`Count`."""
    count = Count()
    mode = _Counter(count)
    _ACTIVE.append(mode)
    _build.RECORDERS.append(mode.kernel)
    try:
        with mode:
            yield count
    finally:
        _build.RECORDERS.remove(mode.kernel)
        _ACTIVE.remove(mode)


def steps(n: int, like: torch.Tensor) -> Iterable[int]:
    """The steps ``0 … n - 1`` of a Python loop over time whose steps are the
    same ops on the same shapes, its inputs shaped like ``like``.

    Under :func:`counting`, on ``"meta"``, it runs fewer steps and scales their
    counts, exactly (the loop rule):

    * without a graph (``like`` needs no gradient), step 0 alone, its counts
      times ``n``;
    * under autograd, steps 0, 1 and 2, step 1's counts times ``n - 2``, in the
      forward and in the backward of the autograd nodes it made (read by their
      sequence numbers).  Three steps keep the backward's gradient sums exact:
      a tensor made outside the loop gets ``n`` gradients, one a step, and sums
      them ``n - 1`` times; step 2's reach it first, then step 1's ``n - 2``
      times and step 0's once.  Step 1's inputs need gradients, as a middle
      step's do.

    The caller passes what the loop collected a step through :func:`fill`."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    if mode is None or not like.is_meta:
        yield from range(n)
        return
    graph = torch.is_grad_enabled() and like.requires_grad
    if not graph:
        if n:
            mode.scale *= n
            try:
                yield 0
            finally:
                mode.scale //= n
        return
    if n <= 3:
        yield from range(n)
        return
    yield 0
    first = torch._C._autograd._get_sequence_nr()
    mode.scale *= n - 2
    try:
        yield 1
    finally:
        mode.scale //= n - 2
        mode.ranges.append((first, torch._C._autograd._get_sequence_nr(), n - 2))
    yield 2


def fill(per_step: list, n: int) -> list:
    """What a loop of :func:`steps` collected, one item a step, as ``n`` items:
    unchanged where every step ran, else the last step's item ``n`` times (so a
    tensor made outside the loop is summed from ``n`` gradients, as over every
    step)."""
    return per_step if len(per_step) == n else [per_step[-1]] * n


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Effective ring-traffic bytes a device of one collective of ``nbytes`` a
    device (the gathered result, the reduced tensor, the scattered output) over
    ``group`` ranks: JAX's ``parse_collectives`` factors."""
    g = max(group, 1)
    kind = kind.replace("_", "-")
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    return float(nbytes)                                  # collective-permute


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes: float      # operand bytes a device
    wire_bytes: float            # effective ring-traffic bytes a device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    n_collectives: int
    by_kind: Dict[str, float]
    flops_by_dtype: Dict[str, float]
    kernel_bytes: float

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(count: Count, calls: Sequence[tuple] = ()) -> Roofline:
    """The roofline of one counted step and its modeled collectives ``calls``
    (``(kind, operand, bytes a device, group)``), on one card."""
    compute = sum(f / PEAKS.get(dt, FP32_OPS_PER_S) for dt, f in count.flops_by_dtype.items())
    by_kind: Dict[str, float] = collections.defaultdict(float)
    for kind, _, nbytes, group in calls:
        by_kind[kind] += wire_bytes(kind, nbytes, group)
    wire = float(sum(by_kind.values()))
    terms = {"compute": compute, "memory": count.hbm_bytes / HBM_BYTES_PER_S,
             "collective": wire / NVLINK_BYTES_PER_S}
    return Roofline(
        flops=count.flops, hbm_bytes=count.hbm_bytes,
        collective_bytes=float(sum(c[2] for c in calls)), wire_bytes=wire,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=max(terms, key=terms.get),
        n_collectives=len(calls), by_kind=dict(by_kind),
        flops_by_dtype=dict(count.flops_by_dtype), kernel_bytes=count.kernel_bytes)


def model_flops(n_params: int, tokens: int, kind: str,
                n_active: Optional[int] = None) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N_active·D for prefill and decode
    (JAX's ``model_flops``, ``n_active`` included)."""
    n = n_active if n_active is not None else n_params
    if kind == "train":
        return 6.0 * n_params * tokens if n_active is None else 6.0 * n * tokens
    return 2.0 * n * tokens


def bound(nbytes: float, nops: float = 0.0, ops_rate: float = FP32_OPS_PER_S):
    """The least ms the card could take to move ``nbytes`` and do ``nops`` at
    ``ops_rate``, and which of the two bounds it: ``(ms, "bytes" | "operations")``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / ops_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
