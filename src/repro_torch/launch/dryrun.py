"""Dry run of the model stack on a production mesh: build every (arch x
shape x mesh) cell's step at full width on a fake process group of 256
or 512 ranks, run it on stand-ins that allocate nothing, and record its
per-device costs (ports ``repro/launch/dryrun.py``).

For every eligible cell this module:
  1. holds rank 0 of a fake process group (``torch.testing._internal.
     distributed.fake_pg``: one process, a world of any size, every
     collective returns at once) and builds the production mesh on it
     (``mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16);
  2. builds the step (``make_train_step`` / ``transformer.prefill`` /
     ``transformer.decode_step``) and its state from shapes, as the
     reference's ``eval_shape`` does: every parameter, moment, cache and
     input a fake tensor (``FakeTensorMode``) holding rank 0's shard,
     placed as a DTensor by the reference's spec trees;
  3. runs the step: DTensor's sharding propagation, every redistribution
     and every kernel operator's checks (``kernels/*/ops.py``: the
     launch's ``ValueError``s) run as on the card, proving that the
     sharding is coherent and each kernel call legal; the wall time of
     this run is ``trace_s`` (the reference's ``lower_s`` / ``compile_s``);
  4. runs it again under ``counting.StepCounter``, whose per-device FLOPs,
     bytes, kernel calls, collectives and memory are recorded with the
     roofline terms (``roofline.analyze``, an H100's peaks) to a JSON
     under ``experiments/dryrun_torch/<mesh>/``.

The second run is counted because DTensor's first sight of an op signature
runs the op at the global shape to infer its output (``counting``'s
docstring).  The reference extrapolates from two unrolled depths because
XLA counts a loop body once; the port's layer loop is eager and every
layer is counted, so the full-depth run is counted as it is
(``--no-counting`` skips the counted run).  For the same reason the
reference's ``flags.unrolled_scans`` has no counterpart here.

Stand-ins are on ``cuda`` (``--device cuda``, the default: the kernels'
operators take every call the card would) or ``cpu`` (the plain kernel
versions, as every CPU path of the port).  On a torch built without CUDA,
``cuda`` stand-ins run forward cells (prefill, decode); a train cell
raises, because autograd's engine asks for a CUDA device.  Train cells
of archs with attention layers take ``impl="chunked"``: flash has no
backward, and ``auto`` would pick it above 2048 keys (the one ``impl``
also sends a hybrid's mamba layers to the plain scan, as in the
reference); mamba2-780m keeps ``auto``, so the SSD operator is on its
train path.  Prefill keeps ``auto``, so the flash operator is on its
path.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs import get_config
from ..models import transformer
from ..models.config import SHAPES
from ..models.layers import P, ShardingRules, placements, set_mesh
from ..train import AdamWConfig, make_train_step, state_specs
from ..train.step import batch_specs as batch_spec_tree
from . import roofline
from .counting import StepCounter
from .mesh import make_production_mesh, rules_for_mesh, serve_rules_for_mesh
from .shapes import (Cell, all_cells, cell, decode_token_specs,
                     prefill_batch_specs, train_batch_specs)

__all__ = ["fake_group", "stand_ins", "build_step", "counting_costs",
           "run_cell", "summarize", "main"]


@contextlib.contextmanager
def fake_group(world_size: int, rank: int = 0):
    """Hold ``rank`` of a fake process group of ``world_size`` ranks for
    the block.  A process that already has a default group raises: the
    dry run would otherwise replace it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run holds a fake process group of its "
                           "own; this process already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# Stand-ins
# ---------------------------------------------------------------------- #
def _dims(i) -> int:
    """How many dims of the indexed tensor index ``i`` takes."""
    if i is None or i is Ellipsis:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return i.dim()
    return 1


def _getitem(t: torch.Tensor, idx) -> Tuple[torch.Tensor, list]:
    """``t[idx]``'s basic part through the dispatcher's ops (ints,
    slices, ``None``, ``...``) and the index tensors left for
    ``aten.index`` / ``aten.index_put_``, one entry a dim of the result
    (None where a dim is not indexed).  Other index forms raise."""
    idx = idx if isinstance(idx, tuple) else (idx,)
    if Ellipsis in idx:
        k = idx.index(Ellipsis)
        used = sum(_dims(i) for i in idx)
        idx = idx[:k] + (slice(None),) * (t.dim() - used) + idx[k + 1:]
    out, d, adv = t, 0, []
    for i in idx:
        if i is None:
            out = out.unsqueeze(d)
        elif isinstance(i, slice):
            if i != slice(None):
                out = torch.ops.aten.slice.Tensor(out, d, i.start, i.stop,
                                                  i.step or 1)
        elif isinstance(i, int) and not isinstance(i, bool):
            out = out.select(d, i)
            continue
        elif isinstance(i, torch.Tensor):
            # a mask is one entry of ``adv`` and takes its dims of ``out``
            covered = sum(1 if a is None else _dims(a) for a in adv)
            adv += [None] * (d - covered) + [i]
            d += _dims(i)
            continue
        else:
            raise TypeError(f"index {i!r} of a fake card tensor")
        d += 1
    return out, adv


def _index(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` through the dispatcher."""
    out, adv = _getitem(t, idx)
    return torch.ops.aten.index.Tensor(out, adv) if adv else out


def _setitem(t: torch.Tensor, idx, value) -> None:
    """``t[idx] = value`` through the dispatcher."""
    view, adv = _getitem(t, idx)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=view.dtype, device=view.device)
    if adv:
        torch.ops.aten.index_put_(view, adv, value)
    else:
        view.copy_(value)


def _is_stand_in(t: torch.Tensor) -> bool:
    """A fake card tensor, or a DTensor over one."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t._local_tensor
    return isinstance(t, FakeTensor) and t.device.type == "cuda"


@contextlib.contextmanager
def _card_indexing():
    """On a torch built without CUDA, route Python's indexing,
    ``contiguous()`` and ``copy_()`` of fake card tensors (``_is_stand_in``)
    through the dispatcher for the block; every other tensor takes the
    built-in methods.  Their C++ bindings take a CUDA device guard, which
    such a build cannot give; the ops they decompose to need none.  On a
    CUDA build nothing changes."""
    if torch.backends.cuda.is_built():
        yield
        return
    T = torch.Tensor
    names = ("__getitem__", "__setitem__", "contiguous", "copy_")
    own = {n: T.__dict__.get(n) for n in names}
    base = {n: getattr(T, n) for n in names}

    def getitem(self, idx):
        if not _is_stand_in(self):
            return base["__getitem__"](self, idx)
        return _index(self, idx)

    def setitem(self, idx, value):
        if not _is_stand_in(self):
            return base["__setitem__"](self, idx, value)
        _setitem(self, idx, value)

    def contiguous(self, memory_format=torch.contiguous_format):
        if (not _is_stand_in(self)
                or self.is_contiguous(memory_format=memory_format)):
            return base["contiguous"](self, memory_format=memory_format)
        return torch.ops.aten.clone.default(self,
                                            memory_format=memory_format)

    def copy_(self, src, non_blocking=False):
        if not _is_stand_in(self):
            return base["copy_"](self, src, non_blocking)
        return torch.ops.aten.copy_.default(self, src, non_blocking)

    T.__getitem__, T.__setitem__, T.contiguous = getitem, setitem, contiguous
    T.copy_ = copy_
    try:
        yield
    finally:
        for n in names:
            if own[n] is None:
                delattr(T, n)
            else:
                setattr(T, n, own[n])


@contextlib.contextmanager
def stand_ins():
    """The ``FakeTensorMode`` a cell is built and run in (with Python's
    indexing of fake card tensors on a build without CUDA)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True), _card_indexing():
        yield


def _contiguous_strides(shape) -> Tuple[int, ...]:
    st, acc = [], 1
    for n in reversed(shape):
        st.append(acc)
        acc *= n
    return tuple(reversed(st))


def stand_in(shape, dtype: torch.dtype, spec, mesh):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, whose
    local shard is rank 0's (an empty tensor: fake inside
    ``stand_ins``).  DTensor shards as ``torch.chunk``: rank 0 holds the
    ceiling of every split, as the reference pads each shard to."""
    from torch.distributed.tensor import DTensor, Shard
    pl = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] = -(-local[p.dim] // mesh.size(i))
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device=mesh.device_type), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=_contiguous_strides(shape))


def _param_metas(cfg, dtype) -> Dict[str, torch.Tensor]:
    """Every parameter by ``named_params``' names, from ``init_params`` on
    the meta device (shapes and dtypes only)."""
    model = transformer.init_params(cfg, torch.Generator(), dtype, "meta")
    return dict(model.named_parameters())


def _placed(metas: Dict[str, torch.Tensor], specs, mesh, as_dtype=None):
    """A stand-in of each of ``metas`` placed by its spec (``as_dtype``:
    every leaf in that dtype instead of its own)."""
    return {n: stand_in(m.shape, as_dtype or m.dtype, specs[n], mesh)
            for n, m in metas.items()}


# ---------------------------------------------------------------------- #
# Cells
# ---------------------------------------------------------------------- #
def _cell_rules(c: Cell, mesh, rules_override) -> ShardingRules:
    if rules_override is not None:
        rules = rules_override
    elif c.kind == "decode":
        rules = serve_rules_for_mesh(mesh)   # pure TP: no per-token gathers
    else:
        rules = rules_for_mesh(mesh)
    # batch=1 long-context cells cannot shard the batch dim; the KV cache
    # sequence sharding over 'model' carries the parallelism instead
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    b_axes = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    divisor = 1
    for a in b_axes:
        divisor *= sizes.get(a, 1) if a else 1
    if c.global_batch % divisor:
        rules = dataclasses.replace(rules, batch=None)
    return rules


def build_step(c: Cell, mesh, ce_chunk: int = 512, rules_override=None,
               extra: Optional[Dict] = None, cfg_override=None,
               dtype: torch.dtype = torch.bfloat16
               ) -> Tuple[Callable[[], Any], Tuple]:
    """(step, arguments) for one cell on ``mesh``: ``step()`` runs it on
    ``arguments``, the stand-ins of its state and inputs.  Call inside
    ``stand_ins()``.  ``dtype`` is the parameters' (the reference's
    ``init_params`` default, bf16); moments are float32."""
    cfg = cfg_override or get_config(c.arch)
    rules = _cell_rules(c, mesh, rules_override)
    extra = extra or {}
    if c.kind == "train":
        if mesh.device_type == "cuda" and not torch.backends.cuda.is_built():
            raise RuntimeError(
                "a train cell on cuda stand-ins needs a torch built with "
                "CUDA (autograd's engine asks for a CUDA device); this one "
                "has none: run with --device cpu, or on the card's machine")
        st = state_specs(cfg, rules)
        metas = _param_metas(cfg, dtype)
        f32 = torch.float32
        state = {"params": _placed(metas, st["params"], mesh),
                 "opt": {"step": stand_in((), torch.int32, P(), mesh),
                         "m": _placed(metas, st["opt"]["m"], mesh, f32),
                         "v": _placed(metas, st["opt"]["v"], mesh, f32)}}
        batch = _placed(train_batch_specs(cfg, c.global_batch, c.seq_len),
                        batch_spec_tree(cfg, rules), mesh)
        # flash has no backward: an arch with attention layers trains on
        # chunked attention (one impl for every layer, as the reference's,
        # so a hybrid's mamba layers take the plain scan too); an
        # attention-free arch keeps auto, the SSD operator
        attention = any(cfg.layer_kind(i) == "a"
                        for i in range(cfg.num_layers))
        step = make_train_step(cfg, AdamWConfig(), rules, **{
            "impl": "chunked" if attention else "auto",
            "ce_chunk": ce_chunk, **extra})
        return (lambda: step(state, batch)), (state, batch)

    params = _placed(_param_metas(cfg, dtype),
                     transformer.param_specs(cfg, rules), mesh)
    model = transformer.model_from_named(cfg, params)
    if c.kind == "prefill":
        batch = _placed(prefill_batch_specs(cfg, c.global_batch,
                                            c.seq_len),
                        batch_spec_tree(cfg, rules), mesh)

        kw = {"cache_len": c.seq_len, "patch_embeds": batch.get(
            "patch_embeds"), "rules": rules, **extra}

        def prefill():
            with set_mesh(mesh):
                return transformer.prefill(model, batch["tokens"], **kw)
        return prefill, (params, batch)

    # decode
    c_specs = transformer.cache_specs(cfg, rules)
    caches = [{n: stand_in(t.shape, t.dtype, c_specs[i][n], mesh)
               for n, t in layer.items()}
              for i, layer in enumerate(transformer.init_caches(
                  cfg, c.global_batch, c.seq_len, device="meta"))]
    tok_meta, pos_meta = decode_token_specs(cfg, c.global_batch)
    tok_spec = P(rules.batch, None, None) if cfg.family == "audio" \
        else P(rules.batch, None)
    tokens = stand_in(tok_meta.shape, tok_meta.dtype, tok_spec, mesh)
    # the position is replicated (the reference's P()): a plain tensor,
    # as the serving engine passes it, enters DTensor ops as replicated
    pos = torch.empty(pos_meta.shape, dtype=pos_meta.dtype,
                      device=mesh.device_type)

    def decode():
        with set_mesh(mesh):
            return transformer.decode_step(model, caches, tokens, pos, rules)
    return decode, (params, caches, tokens, pos)


def counting_costs(step: Callable[[], Any], arguments: Tuple
                   ) -> Dict[str, Any]:
    """Per-device costs of one run of ``step`` (a warmed one: DTensor's
    sharding propagation cached), counted by ``StepCounter``."""
    gc.collect()
    with StepCounter(arguments) as counter:
        out = step()
        counter.finish(out)
    del out
    return {"memory_analysis": counter.memory_analysis,
            "cost_analysis": counter.cost_analysis,
            "collectives": counter.collectives,
            "kernel_calls": dict(sorted(counter.kernel_calls.items()))}


def _write(result: Dict[str, Any], out_dir: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{result['arch']}__{result['shape']}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(result, f, indent=1)


def run_cell(c: Cell, mesh, mesh_name: str, out_dir: str,
             ce_chunk: int = 512, rules_override=None,
             extra: Optional[Dict] = None,
             counting: bool = True, cfg_override=None,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Build and run cell ``c`` on ``mesh`` (the module docstring); the
    result dict, also written to ``out_dir`` (unless empty)."""
    chips = mesh.size()
    result: Dict[str, Any] = {
        "arch": c.arch, "shape": c.shape, "kind": c.kind,
        "global_batch": c.global_batch, "seq_len": c.seq_len,
        "mesh": mesh_name, "chips": chips, "eligible": c.eligible,
        "device": mesh.device_type,
        "param_dtype": str(dtype).removeprefix("torch."),
    }
    if not c.eligible:
        result["skipped"] = c.skip_reason
        _write(result, out_dir)
        return result
    cfg = cfg_override or get_config(c.arch)
    result["layers"] = cfg.num_layers
    with stand_ins():
        t0 = time.perf_counter()
        step, arguments = build_step(c, mesh, ce_chunk, rules_override,
                                     extra, cfg, dtype)
        step()
        result["trace_s"] = round(time.perf_counter() - t0, 2)
        if counting:
            t1 = time.perf_counter()
            result.update(counting_costs(step, arguments))
            result["counting_s"] = round(time.perf_counter() - t1, 2)
        del step, arguments
    if counting:
        result["roofline"] = roofline.analyze(result, cfg, chips)
    _write(result, out_dir)
    return result


def summarize(result: Dict[str, Any]) -> str:
    if result.get("skipped"):
        return (f"SKIP  {result['arch']:22s} {result['shape']:12s} "
                f"({result['skipped'][:40]}...)")
    if "roofline" not in result:
        return (f"OK    {result['arch']:22s} {result['shape']:12s} "
                f"trace={result['trace_s']:6.1f}s")
    t = result["roofline"]
    return (f"OK    {result['arch']:22s} {result['shape']:12s} "
            f"trace={result['trace_s']:6.1f}s "
            f"count={result['counting_s']:6.1f}s "
            f"comp={t['compute_s']:.3f}s mem={t['memory_s']:.3f}s "
            f"coll={t['collective_s']:.3f}s dom={t['dominant']:10s} "
            f"frac={t['roofline_fraction']:.3f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--no-counting", action="store_true",
                    help="run each step once and count nothing (the "
                         "coherence proof only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the stand-ins' device: cuda takes the kernels' "
                         "operators, cpu their plain versions")
    args = ap.parse_args()
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [cell(args.arch, args.shape)]
    else:
        raise SystemExit("--arch and --shape, or --all")

    mesh_name = "multi_pod" if args.multi_pod else "single_pod"
    out_dir = os.path.join(args.out, mesh_name)
    failures = []
    with fake_group(512 if args.multi_pod else 256):
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=args.device)
        for c in cells:
            done = os.path.join(out_dir, f"{c.arch}__{c.shape}.json")
            if args.skip_done and os.path.exists(done):
                print(f"done  {c.arch:22s} {c.shape}")
                continue
            try:
                result = run_cell(c, mesh, mesh_name, out_dir,
                                  ce_chunk=args.ce_chunk,
                                  counting=not args.no_counting)
                print(summarize(result), flush=True)
                ma = result.get("memory_analysis")
                if ma:
                    print(f"      memory: args="
                          f"{ma['argument_size_in_bytes']} "
                          f"temp={ma['temp_size_in_bytes']}", flush=True)
            except Exception as e:
                failures.append((c.arch, c.shape, repr(e)))
                print(f"FAIL  {c.arch:22s} {c.shape:12s} {e!r}", flush=True)
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cell(s) failed: {failures}")


if __name__ == "__main__":
    main()
