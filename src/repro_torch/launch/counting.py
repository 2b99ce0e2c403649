"""Per-device counts of one step over DTensors: the port's stand-in for
XLA's ``cost_analysis()``, ``memory_analysis()`` and the collectives the
reference's dry run parses out of the compiled HLO
(``repro/launch/dryrun.py``, ``repro/launch/roofline.py``).

``StepCounter`` is a ``TorchDispatchMode``.  It declines every call on a
DTensor, so DTensor's dispatch runs and the mode sees what DTensor issues
on this rank beneath it: the local ops on the local shards, the
redistributions' collectives and the kernels' operators.  From those it
records, per device:

* **FLOPs**, by ``torch.utils.flop_counter``'s formulas, which hold the
  kernels' operators' own (``flash_attention``, ``ssd_scan``);
* **bytes accessed**: each op's tensor inputs read once (an expanded
  view no more than its storage) and its tensor outputs written once; a
  view (an output on an input's storage) and a bare allocation
  (``empty``) move nothing.  This is what an eager
  program moves, op by op.  XLA counts after fusion, where an
  intermediate that stays on chip costs nothing, so the two are not the
  same quantity: this one is larger;
* **kernel calls**, by operator (the ``repro_torch`` namespace);
* **collectives**, under the reference's five names, each with
  ``count``, ``result_bytes`` and ``wire_bytes`` (``roofline._wire_bytes``
  at the op's group size), and ``total_wire_bytes``: the schema of
  ``repro.launch.roofline.parse_collectives``.  The eager ``c10d`` ops
  count as their functional twins; a point-to-point send is a
  ``collective-permute`` of its bytes;
* **memory**: the storages alive at once, tracked through their
  lifetimes.  ``argument_size_in_bytes`` is the step's inputs (the local
  shards of state and batch), ``output_size_in_bytes`` its outputs' new
  storages, and ``temp_size_in_bytes`` the peak minus the arguments.

DTensor infers an op's output shape by running the op once on stand-ins
of the *global* shapes (its sharding propagation), and caches the result
by the op's signature.  Those calls pass through this mode too and are
not the device's work.  So the caller runs the step once first and
counts a second run, in which every signature is cached and only the
per-rank work is issued (``launch/dryrun.py``).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .roofline import _COLLECTIVES, _wire_bytes

__all__ = ["StepCounter"]

#: dispatcher ops -> the reference's collective names
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d._allgather_base_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}
#: c10d ops that move no data of their own
_COMM_FREE = {"_c10d_functional.wait_tensor", "c10d.recv_", "c10d.barrier"}
#: allocations: they write nothing
_ALLOC = {"aten.empty", "aten.empty_strided", "aten.empty_like",
          "aten.new_empty", "aten.new_empty_strided"}


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _read(t: torch.Tensor) -> int:
    """Bytes an op reads of input ``t``: its elements, but no more than
    its storage holds (an expanded view, as ``layers.dense``' batched
    weight, reads its storage once)."""
    return min(_nbytes(t), t.untyped_storage().nbytes())


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _group_size(func, args, kwargs) -> int:
    """The size of the group a collective runs over: its ``group_name``
    argument (functional ops) or its ``ProcessGroup`` (eager ``c10d``
    ops)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    if "group_name" in named:
        return _resolve_process_group(named["group_name"]).size()
    for a in named.values():
        if isinstance(a, torch.ScriptObject) and \
                str(a._type()).endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    raise ValueError(f"{func}: a collective without a group")


class StepCounter(TorchDispatchMode):
    """Counts the per-device work of the ops run inside it (the module
    docstring).  ``arguments``: the step's inputs, whose storages are
    alive when it starts; call ``finish(outputs)`` after the step, then
    read ``memory_analysis``, ``cost_analysis``, ``collectives`` and
    ``kernel_calls``."""

    def __init__(self, arguments: Iterable[Any]):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.kernel_calls: Dict[str, int] = {}
        self.collectives: Dict[str, Any] = {
            op: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
            for op in _COLLECTIVES}
        self.collectives["total_wire_bytes"] = 0.0
        self._args = {}
        for t in _tensors(list(arguments)):
            if isinstance(t, _dtensor_type()):
                t = t.to_local()
            st = t.untyped_storage()
            self._args[id(st)] = st.nbytes()
        self.argument_bytes = sum(self._args.values())
        self._live: Dict[int, int] = {}      # new storages alive: id -> bytes
        self.live = self.argument_bytes
        self.peak = self.live
        self.output_bytes = 0

    # -- storages ---------------------------------------------------------- #
    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    # -- ops --------------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        if name in _COMM_FREE:
            return out
        if name in _COLLECTIVE_OPS:
            self._collective(_COLLECTIVE_OPS[name], func, args, kwargs,
                             out)
        elif func.namespace == "repro_torch":
            op = func.overloadpacket.__name__
            self.kernel_calls[op] = self.kernel_calls.get(op, 0) + 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if name in _ALLOC:
            return out
        mutable = func._schema.is_mutable
        in_st = {id(t.untyped_storage()) for t in ins}
        if not mutable and all(id(t.untyped_storage()) in in_st
                               for t in outs):
            return out                      # a view, or no tensor out
        self.bytes_accessed += sum(map(_read, ins)) + sum(
            map(_nbytes, outs))
        formula = torch.utils.flop_counter.flop_registry.get(
            func.overloadpacket)
        if formula is not None:
            self.flops += float(formula(*args, **kwargs, out_val=out))
        return out

    def _collective(self, op: str, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        if name.startswith("_c10d_functional") or name.startswith("_dtensor"):
            result = sum(map(_nbytes, _tensors(out)))
        elif name in ("c10d.allreduce_", "c10d.send"):
            result = sum(map(_nbytes, _tensors(args[0])))
        else:                               # (output, input, ...) in place
            result = _nbytes(args[0])
        p = _group_size(func, args, kwargs)
        rec = self.collectives[op]
        rec["count"] += 1
        rec["result_bytes"] += result
        w = _wire_bytes(op, result, p)
        rec["wire_bytes"] += w
        self.collectives["total_wire_bytes"] += w

    # -- results ----------------------------------------------------------- #
    def finish(self, outputs: Any) -> None:
        """Record the step's outputs (their storages new to the step)."""
        seen = set()
        for t in _tensors(outputs):
            if isinstance(t, _dtensor_type()):
                t = t.to_local()
            st = t.untyped_storage()
            if id(st) in self._args or id(st) in seen:
                continue
            seen.add(id(st))
            self.output_bytes += st.nbytes()

    @property
    def memory_analysis(self) -> Dict[str, int]:
        return {"argument_size_in_bytes": int(self.argument_bytes),
                "output_size_in_bytes": int(self.output_bytes),
                "temp_size_in_bytes": int(self.peak - self.argument_bytes)}

    @property
    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": self.flops, "bytes accessed": self.bytes_accessed}
