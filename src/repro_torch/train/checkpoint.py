"""Layout-agnostic checkpointing (coarse-grained fault tolerance, the
paper's §VI; ports ``repro/train/checkpoint.py``).

* ``save`` copies the state tree to the host and writes one ``.npz`` plus
  a JSON manifest (leaf paths, dtypes, step).  Nothing about devices is
  stored, so a checkpoint restores onto any device.
  ``AsyncCheckpointer.save`` copies to the host on the caller's thread
  and writes on a worker thread, off the training critical path.
* ``restore`` loads into the structure of ``like``, each leaf on
  ``like``'s device (or ``device``), and raises on a shape mismatch.
  With ``shardings`` (a tree of specs matching ``like``) each full leaf
  is placed onto the current mesh (``models.layers.set_mesh``) by its
  spec: the elastic restart onto another mesh shape, since the npz
  holds full arrays.

On a mesh the state's leaves are DTensors: ``save`` gathers each with
``full_tensor()`` (a collective every process joins) and the process of
global rank 0 alone writes, then every process waits for the write.

A tree is nested dicts (keys in sorted order, as JAX flattens them),
lists and tuples of tensors.  bfloat16 leaves are stored as their 16-bit
patterns (numpy has no bfloat16); the manifest names their dtype.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..models.layers import P, current_mesh, distribute, full, is_dtensor


def _writer() -> bool:
    """Whether this process writes (rank 0, or no process group)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier_if_sharded(flat) -> None:
    if any(is_dtensor(t) for _, t in flat):
        import torch.distributed as dist
        dist.barrier()


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [leaf for i, v in enumerate(tree)
                for leaf in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like: Any, leaves) -> Any:
    if isinstance(like, dict):
        # leaves come in sorted-key order; the result keeps like's order
        got = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: got[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(t: torch.Tensor) -> np.ndarray:
    t = full(torch.as_tensor(t).detach()).cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _dtype_name(t) -> str:
    return str(torch.as_tensor(t).dtype).replace("torch.", "")


def _write(path: str, arrays, paths, dtypes, step) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"a{i}": a for i, a in enumerate(arrays)})
    os.replace(tmp, path + ".npz")
    manifest = {"num_leaves": len(arrays), "step": step, "paths": paths,
                "dtypes": dtypes}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def save(path: str, state: Any, step: Optional[int] = None) -> None:
    """Copy ``state`` to the host and write ``path`` (.npz + .json)."""
    flat = _flatten(state)
    arrays = [_host(t) for _, t in flat]
    if _writer():
        _write(path, arrays, [p for p, _ in flat],
               [_dtype_name(t) for _, t in flat], step)
    _barrier_if_sharded(flat)


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread (one in flight at a
    time)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, path: str, state: Any, step: Optional[int] = None
             ) -> None:
        self.wait()
        # the host copy on the caller's thread (ordered after the step
        # that made the state); file IO on the worker
        flat = _flatten(state)
        args = ([_host(t) for _, t in flat], [p for p, _ in flat],
                [_dtype_name(t) for _, t in flat], step)
        if not _writer():
            return
        self._thread = threading.Thread(target=_write, args=(path,) + args,
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def restore(path: str, like: Any, device=None, shardings: Any = None
            ) -> Any:
    """Load a checkpoint into the structure of ``like``: each leaf gets
    ``like``'s dtype and lands on ``device`` (default: ``like``'s leaf's
    device).  With ``shardings`` (specs in ``like``'s structure) each leaf
    is placed onto the current mesh by its spec."""
    flat_like = [t for _, t in _flatten(like)]
    specs = None
    if shardings is not None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("restore(shardings=...) places onto the current "
                             "mesh: call it under models.layers.set_mesh")
        specs = [s for _, s in _flatten(shardings)]
    with np.load(path + ".npz") as z:
        if len(z.files) != len(flat_like):
            raise ValueError(f"checkpoint has {len(z.files)} leaves, "
                             f"expected {len(flat_like)}")
        flat = [z[f"a{i}"] for i in range(len(flat_like))]
    out = []
    for i, (a, l) in enumerate(zip(flat, flat_like)):
        l = torch.as_tensor(l)
        if tuple(a.shape) != tuple(l.shape):
            raise ValueError(f"leaf {i}: shape {a.shape} != "
                             f"{tuple(l.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(a))
        t = t.view(torch.bfloat16) if l.dtype == torch.bfloat16 and \
            t.dtype == torch.int16 else t.to(l.dtype)
        t = t.to(l.device if device is None else device)
        out.append(t if specs is None else distribute(t, specs[i], mesh))
    return _unflatten(like, iter(out))


def latest_step(directory: str, prefix: str = "ckpt_") -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(".json"):
            try:
                steps.append(int(name[len(prefix):-len(".json")]))
            except ValueError:
                pass
    return max(steps) if steps else None
