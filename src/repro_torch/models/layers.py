"""Shared neural-net building blocks (ports ``repro/models/layers.py``).

Parameters are plain tensors or DTensors held by the caller (the model's
``nn.Module``s, or a dict in the tests); every block is a function of
them.  The initializers draw from an explicit ``torch.Generator``
instead of a ``jax.random`` key, so the same seed gives other numbers
than the JAX package (tests carry weights across with
``transformer.params_from_numpy`` instead).

Sharding is the reference's vocabulary on a ``torch.distributed``
``DeviceMesh`` with axes ``("data", "model")`` (``launch.mesh``):

* ``ShardingRules`` maps logical axes (``batch``, ``fsdp``, ``model``,
  ``tp``) to mesh axes; ``logical`` returns a spec ``P``, a tuple of
  mesh-axis names, ``None`` or tuples of names, one entry a tensor dim.
  Spec trees are data, comparable with the JAX package's string for
  string.
* ``placements(spec, mesh)`` turns a spec into DTensor placements: a mesh
  axis named at dim i is ``Shard(i)`` on that mesh dim, an axis no dim
  names is ``Replicate()``, and a tuple of axes on one dim shards it over
  those mesh dims in mesh order.
* ``set_mesh(mesh)`` holds the current mesh for the thread (the
  reference's ``compat.set_mesh``) and lets plain tensors (constants,
  masks built with ``torch.arange``) enter DTensor ops as replicated.
  ``constrain(x, rules, *axes)`` is the identity when ``rules`` is
  disabled or no mesh is current, and otherwise redistributes the
  DTensor ``x`` onto the current mesh: the counterpart of
  ``with_sharding_constraint``, with DTensor's sharding propagation in
  the role of GSPMD's between the constraints.
* Kernel call sites on a sharded path take local tensors through
  ``torch.distributed.tensor.experimental.local_map`` (the reference's
  ``shard_map``); the kernel dispatchers refuse DTensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import threading
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------- #
# Sharding rules: logical axes -> mesh axes
# ---------------------------------------------------------------------- #
class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh-axis name,
    a tuple of names or None (the reference's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical -> mesh axis mapping, with the reference's two weight
    schemes in one vocabulary:

    * **train** (``tp_weights=False``): ZeRO-3, weights sharded over
      ``fsdp`` and replicated over ``model``; the model axis carries
      sequence-parallel activations, experts and the vocab-parallel
      embedding.  ``tp`` resolves to None.
    * **serve** (``tp_weights=True``): Megatron TP, ``tp`` resolves to
      the model axis.

    ``model`` always means the physical model axis; ``tp`` means "the
    model axis iff serving"."""

    batch: Union[str, Tuple[str, ...], None] = None
    fsdp: Union[str, None] = None
    model: Union[str, None] = None
    tp_weights: bool = False
    model_size: int = 1
    data_size: int = 1

    def logical(self, *axes: Optional[str]) -> P:
        """The spec of logical axis names."""
        out = []
        for a in axes:
            if a is None:
                out.append(None)
            elif a == "batch":
                out.append(self.batch)
            elif a == "fsdp":
                out.append(self.fsdp)
            elif a == "model":
                out.append(self.model)
            elif a == "tp":
                out.append(self.model if self.tp_weights else None)
            else:
                raise ValueError(a)
        return P(*out)

    @property
    def enabled(self) -> bool:
        return any(x is not None for x in (self.batch, self.fsdp, self.model))


NO_SHARDING = ShardingRules()

_CURRENT = threading.local()


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the thread's current mesh, with
    plain tensors replicated into DTensor ops, for the block."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = getattr(_CURRENT, "mesh", None)
    _CURRENT.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _CURRENT.mesh = prev


def mesh_scope(t: torch.Tensor):
    """``set_mesh`` of the DTensor ``t``'s mesh, or a null context for a
    plain tensor."""
    return set_mesh(t.device_mesh) if is_dtensor(t) \
        else contextlib.nullcontext()


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full tensor (a collective over its mesh); a plain
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def current_mesh():
    """The thread's current ``DeviceMesh`` (``set_mesh``), or None."""
    return getattr(_CURRENT, "mesh", None)


def is_dtensor(x: Any) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(spec: Sequence[Any], mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = [a for a in axes if a is not None]
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names mesh axis {a!r}, mesh "
                                 f"has {names}")
            if a in seen:
                raise ValueError(f"spec {spec} names {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {tuple(axes)} on one dim "
                             f"must follow the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def distribute(x: torch.Tensor, spec: Sequence[Any], mesh):
    """The full tensor ``x`` (the same on every rank) placed on ``mesh``
    by ``spec``.  On a mesh of one rank the DTensor wraps ``x`` itself
    (every shard is the whole tensor): no copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh.size() == 1:
        return DTensor.from_local(x, mesh, placements(spec, mesh),
                                  run_check=False)
    return distribute_tensor(x, mesh, placements(spec, mesh))


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x (..., D) and w (D, F).  A DTensor x of three dims
    takes a batched product over its leading dim instead: the matmul of a
    3-D tensor flattens its leading dims, which are both sharded under
    sequence-parallel rules, and DTensor before torch 2.13 refuses to
    merge two sharded dims."""
    if x.dim() == 3 and is_dtensor(x):
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    return x @ w


def assign(dst: torch.Tensor, value: torch.Tensor) -> None:
    """``dst.copy_(value)``; a DTensor ``dst`` keeps its placements."""
    if is_dtensor(dst):
        value = value.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(value)


def constrain(x: torch.Tensor, rules: ShardingRules, *axes: Optional[str]):
    """Activation sharding constraint: ``x`` redistributed to the spec of
    ``axes`` on the current mesh.  The identity when ``rules`` is
    disabled or no mesh is current (the stacked ranks of one device)."""
    if not rules.enabled:
        return x
    mesh = current_mesh()
    if mesh is None:
        return x
    if not is_dtensor(x):
        raise TypeError("constrain under a mesh takes a DTensor; a plain "
                        "tensor here is a local shard outside its local_map")
    return x.redistribute(mesh, placements(rules.logical(*axes), mesh))


def local_map_on(fn, mesh, out_specs, in_specs):
    """``local_map(fn)`` on ``mesh`` with placements given as specs: the
    reference's ``shard_map`` with ``in_specs`` / ``out_specs``.
    ``out_specs`` is one ``P`` for one output or a tuple of them; a None
    spec marks a non-tensor argument or output.  Inputs are
    redistributed to their placements.
    A spec may also be a list of placements (e.g. ``partial_over``).
    An input replicated over a mesh dim that another input is sharded
    over takes its gradient as ``Partial`` there: each rank's local
    gradient is its share (the transpose of ``shard_map``'s broadcast)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def pl(s):
        if s is None or isinstance(s, list):
            return s
        return placements(s, mesh)
    outs = pl(out_specs) if isinstance(out_specs, (P, list)) \
        else tuple(pl(s) for s in out_specs)
    ins = tuple(pl(s) for s in in_specs)
    split = {i for p in ins if p for i, q in enumerate(p)
             if isinstance(q, Shard)}
    grads = tuple(None if p is None else
                  [Partial() if isinstance(q, Replicate) and i in split
                   else q for i, q in enumerate(p)] for p in ins)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


def partial_over(axes, mesh) -> list:
    """Placements of a value that is a partial sum over the mesh axes
    ``axes`` (each rank's share) and replicated over the others."""
    from torch.distributed.tensor import Partial, Replicate
    return [Partial() if n in axes else Replicate()
            for n in mesh.mesh_dim_names]


def batch_axes(rules: ShardingRules) -> Tuple[str, ...]:
    """The mesh axes ``rules`` put the batch on."""
    b = rules.batch if isinstance(rules.batch, tuple) else (rules.batch,)
    return tuple(a for a in b if a)


# ---------------------------------------------------------------------- #
# Initializers
# ---------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights, drawn in float32 and cast."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


# ---------------------------------------------------------------------- #
# RMSNorm
# ---------------------------------------------------------------------- #
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS-normalise the last axis in float32, scale, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- #
# Rotary position embedding (half-split, not interleaved)
# ---------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), 0, dtype, device),
    }


def mlp_specs(rules: ShardingRules) -> Dict[str, P]:
    return {"w_gate": rules.logical("fsdp", "tp"),
            "w_up": rules.logical("fsdp", "tp"),
            "w_down": rules.logical("tp", "fsdp")}


def mlp(params: Params, x: torch.Tensor, act: str = "silu",
        rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    gate = dense(x, params["w_gate"])
    up = dense(x, params["w_up"])
    if act == "silu":
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = F.gelu(gate.float(), approximate="tanh").to(x.dtype) * up
    else:
        raise ValueError(act)
    # as the reference: the hidden ff-sharded under TP (serving), sequence-
    # sharded under ZeRO + SP (training)
    if rules.tp_weights:
        h = constrain(h, rules, "batch", None, "model")
    else:
        h = constrain(h, rules, "batch", "model", None)
    return dense(h, params["w_down"])


# ---------------------------------------------------------------------- #
# Cross-entropy (float32 logits, optional z-loss)
# ---------------------------------------------------------------------- #
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.  Mean over
    all positions of ``lse - logit[label]`` (+ ``z_loss * lse**2``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss.mean()
