"""Process-per-rank communicators over a ``torch.distributed`` group.

CylonFlow's ranks are processes that talk through Gloo, MPI or UCX behind
one communicator interface.  The JAX package runs its ``p`` ranks as the
``p`` devices of one mesh under ``shard_map``; in PyTorch, ranks on
separate devices are the processes of a process group.  These classes
are the port's counterpart of that mesh: the calling process holds one
rank (the group's ``rank()``), so every tensor's leading axis has length
1 (``ranks_held()``), and ``size()`` is the group's size.

The registry keeps its schedule names (``get_communicator(name, p,
group=...)``):

  * ``xla``   — the group's native collectives: ``all_to_all_single``,
                ``all_gather_into_tensor``, ``all_reduce`` (SUM, MAX,
                MIN), ``reduce_scatter_tensor``, ``batch_isend_irecv``;
  * ``ring``  — the ring schedules of ``comm.ring``, each roll a send to
                the next process and a receive from the one before;
  * ``bruck`` — the Bruck / recursive-doubling schedules of ``comm.bruck``
                as pairwise sends and receives.

These are the paper's Gloo and UCC schedules, which the JAX package
emulates with ``ppermute``; here they run on the group's links.  Data
movement moves bytes (any dtype, unsigned and bool included); reductions
run in the tensor's dtype.

Transport is the group's backend, chosen by whoever created the group:

  * **NCCL** on the card: card tensors go to the collectives as they are.
    NCCL takes one rank per device, so one card holds a group of one.
  * **gloo** on the CPU.  Gloo's collectives here take host tensors, so
    with card tensors every collective is staged explicitly, and always,
    through pinned host buffers: a copy to the host, the collective, a
    copy back.  ``stats["staged_s"]`` adds up the seconds a process spends
    in staged collectives (copies included).
  * **fake** (``torch.testing._internal.distributed.fake_pg``, the dry
    run's group, ``launch/dryrun.py``): every collective returns at once
    without moving data.  Tensors go to it as they are, as under NCCL:
    the dry run's card tensors are fake and no host buffer can stage
    them.  Its point-to-point sends are counted where they are
    dispatched (``launch/counting.py``, as ``collective-permute``).

Nothing falls back from one transport or schedule to another.  Create the
group with a timeout (``init_process_group(timeout=...)``) so that a
mismatched collective fails instead of hanging.

Host-side exchanges (the out-of-core executor's and the ingest's: spill
rows routed to another process's rank, splitter samples, dictionaries,
the fault agreement) move numpy data through the same group:
``exchange_rows`` (one variable-size all-to-all of the rows' bytes),
``gather_object`` and ``gather_ints`` (an all-gather of a few integers,
from which every process takes the same decision).
Under gloo they run on host tensors; under NCCL through the card.
``stats["host_s"]`` adds up their seconds.

The all-to-all and the point-to-point steps of the ring and Bruck
schedules are differentiable: each is a permutation of blocks across
ranks, whose gradient is the inverse permutation (the all-to-all and a
pairwise exchange are their own inverses, a shift by ``k`` is undone by
a shift by ``-k``).  The MoE shuffle dispatch trains through them.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .bruck import BruckCommunicator
from .ring import RingCommunicator
from .stacked import StackedCommunicator


def _dist():
    import torch.distributed as dist
    return dist


def _as_bytes(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x``'s bytes as a (rows, n) uint8 tensor (a copy only when ``x``
    is not contiguous)."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    return flat.reshape(rows, flat.numel() // rows)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.reshape(-1).view(dtype).reshape(shape)


class _Moved(torch.autograd.Function):
    """A data movement across ranks, ``fwd``, whose gradient is ``bwd``
    (the inverse movement) applied to the output's gradient."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None


def _moved(x: torch.Tensor, fwd: Callable, bwd: Callable) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Moved.apply(x, fwd, bwd)
    return fwd(x)


def _pinned(x: torch.Tensor, copy: bool = False) -> torch.Tensor:
    """A pinned host buffer shaped as ``x`` (holding ``x`` with ``copy``;
    the copy from the card waits for it)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x) if copy else h


class ProcessGroupCommunicator(StackedCommunicator):
    """One rank of a ``torch.distributed`` process group, with the
    group's native collectives (the registry's ``xla``).

    It takes the stacked communicator's schedule helpers, which index
    the ranks held (here one), and overrides every collective and both
    cross-rank steps (``_shift``, ``_xor``)."""

    name = "xla"

    def __init__(self, group=None):
        dist = _dist()
        self.group = group if group is not None else dist.group.WORLD
        super().__init__(dist.get_world_size(self.group))
        self.me = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group)).lower()
        #: "staged_s": seconds spent in host-staged collectives (gloo with
        #: card tensors), copies included; "host_s": seconds in the
        #: host-side exchanges (``exchange_rows``, ``gather_object``,
        #: ``gather_ints``); "host_calls": the host-side collectives those
        #: ran (an ``exchange_rows`` is two: its counts' all-gather and
        #: its all-to-all)
        self.stats = {"staged_s": 0.0, "host_s": 0.0, "host_calls": 0}

    # ------------------------------------------------------------------ #
    def ranks_held(self) -> int:
        return 1

    def rank(self, device=None) -> torch.Tensor:
        return torch.tensor([self.me], dtype=torch.int32, device=device)

    def world(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x)[0]

    def _global(self, group_rank: int) -> int:
        """A group rank's global rank, which point-to-point ops take."""
        dist = _dist()
        if self.group is dist.group.WORLD:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    # -- transport -------------------------------------------------------- #
    def _staged(self, device: torch.device) -> bool:
        if self.backend == "nccl":
            if device.type != "cuda":
                raise ValueError("an NCCL group moves card tensors only; "
                                 "use a gloo group on the CPU")
            return False
        return self.backend != "fake" and device.type == "cuda"

    def _run(self, op: Callable, outs: Sequence[torch.Tensor],
             ins: Sequence[torch.Tensor]) -> None:
        """``op(*outs, *ins)`` over the group; with gloo and card tensors,
        through pinned host buffers."""
        staged = self._staged((list(outs) + list(ins))[0].device)
        t0 = time.perf_counter()
        if staged:
            ins = [_pinned(x, copy=True) for x in ins]
            args = [_pinned(y) for y in outs] + ins
        else:
            args = list(outs) + list(ins)
        with warnings.catch_warnings():
            # newer torch renames *_into_tensor / *_tensor as *_single
            warnings.simplefilter("ignore", FutureWarning)
            op(*args)
        if staged:
            for y, h in zip(outs, args):
                y.copy_(h)
            self.stats["staged_s"] += time.perf_counter() - t0

    def _exchange(self, x: torch.Tensor,
                  pairs: Sequence[Tuple[str, int]]) -> torch.Tensor:
        """Point-to-point: ``pairs`` of ("send", group rank) / ("recv",
        group rank); returns the received tensor (zeros if none)."""
        dist = _dist()
        out = torch.zeros_like(x)
        if not pairs:
            return out
        src = _as_bytes(x, 1)
        dst = _as_bytes(out, 1)

        def op(d, s):
            if all(kind == "send" for kind, _ in pairs):
                d.zero_()       # a (staged) output that receives nothing
            ops = [dist.P2POp(dist.isend if kind == "send" else dist.irecv,
                              s if kind == "send" else d,
                              self._global(peer), self.group)
                   for kind, peer in pairs]
            for w in dist.batch_isend_irecv(ops):
                w.wait()

        self._run(op, [dst], [src])
        return _from_bytes(dst, x.dtype, x.shape)

    # -- host-side exchanges ---------------------------------------------- #
    def _host_device(self) -> torch.device:
        """Where a host exchange's tensors go: the CPU, or the process's
        card under NCCL (which moves card tensors only)."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def gather_ints(self, values: Sequence[int]) -> np.ndarray:
        """(p, len(values)) int64: every process's ``values``, in rank
        order."""
        t0 = time.perf_counter()
        dev = self._host_device()
        x = torch.as_tensor(np.asarray(values, np.int64)).reshape(-1)
        out = torch.empty((self.parallelism * x.numel(),), dtype=torch.int64,
                          device=dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            _dist().all_gather_into_tensor(out, x.to(dev), group=self.group)
        got = out.cpu().numpy().reshape(self.parallelism, x.numel())
        self.stats["host_s"] += time.perf_counter() - t0
        self.stats["host_calls"] += 1
        return got

    def gather_object(self, obj) -> List:
        """Every process's ``obj`` (picklable), in rank order."""
        out: List = [None] * self.parallelism
        t0 = time.perf_counter()
        _dist().all_gather_object(out, obj, group=self.group)
        self.stats["host_s"] += time.perf_counter() - t0
        self.stats["host_calls"] += 1
        return out

    def exchange_rows(self, pieces: Sequence[Optional[Mapping[str,
                                                             np.ndarray]]],
                      schema: Mapping[str, Tuple[np.dtype, Tuple[int, ...]]]
                      ) -> List[Dict[str, np.ndarray]]:
        """Host rows to every process's rank: ``pieces[j]`` (columns of
        ``schema``, or None for no rows) goes to rank ``j``.  Returns what
        each rank sent this one, in rank order (empty columns where it
        sent none).  One all-to-all of the rows' bytes, after one
        all-gather of the row counts."""
        dist = _dist()
        p, dev = self.parallelism, self._host_device()
        names = sorted(schema)
        width = {n: np.dtype(d).itemsize * int(np.prod(s, dtype=np.int64))
                 for n, (d, s) in schema.items()}
        row_bytes = sum(width.values())
        sent = [len(pc[names[0]]) if pc else 0 for pc in pieces]
        got = self.gather_ints(sent)[:, self.me].tolist()
        t0 = time.perf_counter()
        parts = [np.ascontiguousarray(pc[n]).reshape(-1).view(np.uint8)
                 for pc, k in zip(pieces, sent) if k for n in names]
        send = torch.from_numpy(np.concatenate(parts) if parts
                                else np.zeros((0,), np.uint8)).to(dev)
        recv = torch.empty((sum(got) * row_bytes,), dtype=torch.uint8,
                           device=dev)
        dist.all_to_all_single(recv, send, [k * row_bytes for k in got],
                               [k * row_bytes for k in sent],
                               group=self.group)
        flat = recv.cpu().numpy()
        out, at = [], 0
        for k in got:
            cols = {}
            for n in names:
                d, s = schema[n]
                nb = k * width[n]
                cols[n] = flat[at:at + nb].view(np.dtype(d)).reshape(
                    (k,) + tuple(s))
                at += nb
            out.append(cols)
        self.stats["host_s"] += time.perf_counter() - t0
        self.stats["host_calls"] += 1
        return out

    # -- cross-rank steps of the ring and Bruck schedules ----------------- #
    def _shift(self, x: torch.Tensor, k: int) -> torch.Tensor:
        p = self.parallelism
        k %= p
        if k == 0:
            return x.clone()

        def shift(y, j):
            return self._exchange(y, [("send", (self.me + j) % p),
                                      ("recv", (self.me - j) % p)])
        return _moved(x, lambda y: shift(y, k), lambda g: shift(g, p - k))

    def _xor(self, x: torch.Tensor, dist: int) -> torch.Tensor:
        peer = self.me ^ dist

        def swap(y):
            return self._exchange(y, [("send", peer), ("recv", peer)])
        return _moved(x, swap, swap)

    # -- native collectives ----------------------------------------------- #
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, block_major=True)
        return _moved(x, self._all_to_all, self._all_to_all)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        p = self.parallelism
        src = _as_bytes(x[0], p)
        dst = torch.empty_like(src)
        self._run(lambda d, s: _dist().all_to_all_single(
            d, s, group=self.group), [dst], [src])
        return _from_bytes(dst, x.dtype, x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        p = self.parallelism
        src = _as_bytes(x[0], 1)[0]
        dst = src.new_empty((p * src.numel(),))
        self._run(lambda d, s: _dist().all_gather_into_tensor(
            d, s, group=self.group), [dst], [src])
        return _from_bytes(dst, x.dtype, (1, p) + tuple(x.shape[1:]))

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self._check(x)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)

        def run(y, src):
            # in place on the (staged) output, which starts as the input
            y.copy_(src)
            _dist().all_reduce(y, op=op, group=self.group)

        self._run(run, [out], [x.contiguous()])
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, _dist().ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, _dist().ReduceOp.MAX)

    def all_reduce_min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, _dist().ReduceOp.MIN)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, block_major=True)
        src = x[0].contiguous().reshape(-1)
        dst = src.new_empty((src.numel() // self.parallelism,))
        self._run(lambda d, s: _dist().reduce_scatter_tensor(
            d, s, group=self.group), [dst], [src])
        return dst.reshape((1,) + tuple(x.shape[2:]))

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        self._check(x)
        me = self.me
        pairs = ([("send", dst) for src, dst in perm if src == me != dst]
                 + [("recv", src) for src, dst in perm if dst == me != src])
        out = self._exchange(x, pairs)
        return x.clone() if (me, me) in {tuple(pr) for pr in perm} else out


class ProcessGroupRing(RingCommunicator, ProcessGroupCommunicator):
    """The ring schedules over a process group (sends and receives)."""

    name = "ring"

    def __init__(self, group=None):
        ProcessGroupCommunicator.__init__(self, group)


class ProcessGroupBruck(BruckCommunicator, ProcessGroupCommunicator):
    """The Bruck / recursive-doubling schedules over a process group;
    rank counts that are not powers of two take the ring schedules."""

    name = "bruck"

    def __init__(self, group=None):
        ProcessGroupCommunicator.__init__(self, group)
        self._ring = ProcessGroupRing(self.group)
        self._ring.stats = self.stats


_PROCESS_GROUP = {c.name: c for c in (ProcessGroupCommunicator,
                                      ProcessGroupRing, ProcessGroupBruck)}


def process_group_communicator(name: str, group=None
                               ) -> ProcessGroupCommunicator:
    """The ``name`` schedule (``xla`` | ``ring`` | ``bruck``) over
    ``group`` (default: the world group)."""
    try:
        return _PROCESS_GROUP[name](group)
    except KeyError:
        raise ValueError(f"no process-group communicator {name!r}; "
                         f"available: {sorted(_PROCESS_GROUP)}") from None
