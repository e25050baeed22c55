"""What one step costs a device: collective traffic, FLOPs, bytes, memory,
and the roofline terms of the H100.  The port of
``repro/launch/hlo_analysis.py``.

The reference reads a compiled XLA module: ``cost_analysis()`` for FLOPs
and HBM bytes, ``memory_analysis()`` for memory, and the module's text for
the collectives.  PyTorch compiles nothing, so the port records the step as
it runs: :class:`Recorder` is a dispatch mode that sees every op a rank
runs, at the shapes that rank runs it.  The step may run on real tensors
(a rank of a real group) or on fake ones (``launch/dryrun.py``: a fake
process group of the production mesh's size, no allocation, no launch).

What a rank runs.  For an op on DTensors the mode returns
``NotImplemented``, so DTensor takes it apart into the local ops and
collectives each rank issues, and those come back through the mode at local
shapes.  (``FlopCounterMode`` counts the DTensor-level op at global shapes
instead: a [Shard(0), Replicate] x [Replicate, Shard(1)] product on a 16 x
16 mesh counts 256x the work rank 0 does.)  DTensor's sharding propagation
runs each new op signature once on global-shape fake tensors to learn its
output's metadata; those shadow ops are no rank's work and are not counted.
The kernels run inside ``local_map`` on local tensors, through their
registered ops (``kernels/ops.py::flash_attention_op``,
``::rwkv6_fused_op``), whose FLOP formulas the mode reads
from ``torch.utils.flop_counter``'s registry like any aten op's.

Collectives are recorded at the op the model or DTensor issues: the
functional ``_c10d_functional`` ops of DTensor's redistributions and the
``c10d`` ops the port calls directly (``dist.all_reduce`` in
``train/optimizer.py::_sharded_global_norm`` and the sharded loss and
decode attention, ``dist.all_to_all_single`` in ``models/moe.py``), each
with its group's size.  A backend kernel that itself calls c10d (the test
harness's ``testing/gloo_cuda.py``) runs with the mode off, so each
collective is counted once.  ``parse_collectives`` applies the reference's
byte accounting to those records:

  * ``operand_sum`` — Σ operand sizes
  * ``wire_bytes``  — per-device bytes on the links under ring algorithms:
                      AR 2·size·(g-1)/g, AG size·(g-1)/g (size = the
                      gathered result), RS size·(g-1) (size = the shard,
                      the result), A2A size·(g-1)/g, CP size.

Bytes accessed: each op that moves data (not a view, not an allocation)
reads each tensor operand once and writes each output once, the convention
of ``PERF.md`` §2's bounds.  Memory: the bytes of every storage a recorded
op creates on the mesh's device, live until the storage is freed; the peak
of that over the step is ``temp``, and the step's arguments (params,
optimizer state, batch: their local shards) are counted apart.
"""

from __future__ import annotations

import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# op name (namespace::name, overload dropped) -> (kind, where the result
# is): "out" the op's return value, or the index of the argument the op
# writes its result into (the c10d ops work in place)
_COLLECTIVE_OPS = {
    "_c10d_functional::all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional::all_gather_into_tensor_coalesced": ("all-gather",
                                                           "out"),
    "_c10d_functional::reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional::reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                                          "out"),
    "_c10d_functional::all_reduce": ("all-reduce", "out"),
    "_c10d_functional::all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional::all_to_all_single": ("all-to-all", "out"),
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::alltoall_base_": ("all-to-all", 0),
}
# ops that move no bytes of their own
_NO_BYTES = {"aten::empty", "aten::empty_like", "aten::empty_strided",
             "aten::new_empty", "aten::new_empty_strided", "aten::detach",
             "aten::lift_fresh", "aten::_local_scalar_dense",
             "_c10d_functional::wait_tensor", "prim::device"}
KERNEL_NAMESPACE = "repro_torch"


def _op_name(func) -> str:
    return func._schema.name


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over: its ``group_size``
    argument, its process group's size, or its group name's."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    schema = func._schema
    named = dict(kwargs)
    for a, v in zip(schema.arguments, args):
        named[a.name] = v
    if "group_size" in named:
        return int(named["group_size"])
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    if "process_group" in named:          # a c10d op: the boxed group
        from torch.distributed import ProcessGroup
        return ProcessGroup.unbox(named["process_group"]).size()
    raise ValueError(f"{schema.name}: no group size in its arguments")


@dataclass
class CollectiveStats:
    count: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    operand_sum: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    wire_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    @property
    def total_operand_sum(self) -> float:
        return sum(self.operand_sum.values())

    def to_json(self) -> Dict:
        return {"count": dict(self.count),
                "operand_sum": dict(self.operand_sum),
                "wire_bytes": dict(self.wire_bytes),
                "total_wire_bytes": self.total_wire_bytes,
                "total_operand_sum": self.total_operand_sum}


def parse_collectives(records: Iterable[Tuple[str, float, int]],
                      default_group: int = 1) -> CollectiveStats:
    """The reference's accounting of (kind, result bytes, group size)
    records (:attr:`Recorder.collectives`): the result is the gathered
    buffer of an all-gather and the shard of a reduce-scatter, the operand
    otherwise.  A group size below 1 counts as ``default_group``."""
    stats = CollectiveStats()
    for op, total, g in records:
        if op not in COLLECTIVES:
            raise ValueError(f"unknown collective {op!r}")
        total = float(total)
        if total == 0:
            continue
        g = max(g if g and g > 0 else default_group, 1)
        stats.count[op] += 1
        if op == "all-reduce":
            stats.operand_sum[op] += total
            stats.wire_bytes[op] += 2.0 * total * (g - 1) / g
        elif op == "all-gather":
            stats.operand_sum[op] += total / g
            stats.wire_bytes[op] += total * (g - 1) / g
        elif op == "reduce-scatter":
            stats.operand_sum[op] += total * g
            stats.wire_bytes[op] += total * (g - 1)
        elif op == "all-to-all":
            stats.operand_sum[op] += total
            stats.wire_bytes[op] += total * (g - 1) / g
        else:
            stats.operand_sum[op] += total
            stats.wire_bytes[op] += total
    return stats


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

class Recorder(TorchDispatchMode):
    """Counts, at the work one rank does (see the module docstring), every
    op run under it: ``flops`` (the registered FLOP formulas: products,
    convolutions, attention, the kernels' ops), ``bytes`` accessed,
    ``collectives`` ((kind, result bytes, group size) per call),
    ``op_calls`` (calls of the kernels' registered ops by name) and
    ``peak_bytes``, the most bytes the recorded ops' storages on
    ``device_type`` held at once.  One recorder at a time."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        self.device_type = device_type
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.op_calls: Counter = Counter()
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakSet()
        self._shadow = 0
        self._unpatch = None

    # DTensor's output-metadata propagation: its ops are not a rank's work
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        original = ShardingPropagator._propagate_tensor_meta_non_cached
        rec = self

        def shadowed(prop, op_schema):
            rec._shadow += 1
            out = original(prop, op_schema)
            rec._shadow -= 1
            return out
        ShardingPropagator._propagate_tensor_meta_non_cached = shadowed

        def unpatch():
            ShardingPropagator._propagate_tensor_meta_non_cached = original
        self._unpatch = unpatch
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._unpatch()
        return out

    def _track(self, out) -> None:
        for t in _tensors(out):
            if self.device_type and t.device.type != self.device_type:
                continue
            storage = t.untyped_storage()
            if storage in self._seen:
                continue
            self._seen.add(storage)
            n = storage.nbytes()
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor issues the local ops
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        name = _op_name(func)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name.startswith(KERNEL_NAMESPACE + "::"):
            self.op_calls[name.split("::", 1)[1]] += 1
        base = name.split(".")[0]
        if base in _COLLECTIVE_OPS:
            kind, where = _COLLECTIVE_OPS[base]
            result = out if where == "out" else args[where]
            self.collectives.append((kind, _nbytes(result),
                                     _group_size(func, args, kwargs)))
        if base not in _NO_BYTES and not _is_view(func):
            ins = {id(t): t for t in _tensors(list(args) +
                                             list(kwargs.values()))}
            self.bytes += _nbytes(list(ins.values())) + (
                0 if func._schema.is_mutable else _nbytes(out))
            self._track(out)
        return out

    def stats(self) -> CollectiveStats:
        return parse_collectives(self.collectives)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM per-GPU constants (NVIDIA's H100 data sheet, dense rates,
# at the card's 700 W limit), as PERF.md §2 prices every bound:
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
# The network a collective of the production mesh crosses: the per-GPU NIC,
# one 400 Gb/s NDR InfiniBand ConnectX-7 port per H100 (NVIDIA DGX H100
# reference architecture), one direction.  The paper's subject is this
# inter-node fabric; a 16 x 16 mesh spans 32 nodes of 8 GPUs, so its data
# axis always crosses it.  NVLink 4 (18 links, 450 GB/s one way) joins the
# 8 GPUs of a node; t_collective prices every wire byte at the NIC's rate,
# an upper bound for the collectives that stay inside a node.
NIC_BW = 50e9                # bytes/s


@dataclass
class Roofline:
    """All byte / FLOP inputs are PER-DEVICE quantities (what one rank
    runs, :class:`Recorder`); ``model_flops`` is the GLOBAL algorithmic
    requirement (6·N·D style), so the useful-compute ratio divides by
    chips."""

    hlo_flops: float
    hbm_bytes: float
    wire_bytes: float
    chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NIC_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    def to_json(self) -> Dict:
        return {
            "hlo_flops": self.hlo_flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def cost_summary(rec: Recorder) -> Dict[str, float]:
    """The reference's ``cost_analysis`` keys that a recording gives, per
    device: ``flops`` and ``bytes accessed``."""
    return {"flops": float(rec.flops), "bytes accessed": float(rec.bytes)}


def memory_summary(rec: Recorder, argument_bytes: int,
                   output_bytes: int = 0) -> Dict[str, float]:
    """The reference's ``memory_analysis`` keys, per device.
    ``argument_size_in_bytes``: the step's arguments (params, optimizer
    state, batch: the local shards a rank holds); ``temp_size_in_bytes``:
    the recording's peak (the step's peak less its arguments);
    ``output_size_in_bytes``: the outputs' bytes (the new params and
    state, inside the peak too); ``alias_size_in_bytes`` 0 (eager PyTorch
    donates nothing); ``generated_code_size_in_bytes`` 0 (no code is
    generated)."""
    return {"argument_size_in_bytes": float(argument_bytes),
            "output_size_in_bytes": float(output_bytes),
            "temp_size_in_bytes": float(rec.peak_bytes),
            "alias_size_in_bytes": 0.0,
            "generated_code_size_in_bytes": 0.0}
