"""Device meshes and sharding-rule presets (ports ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the processes of
the current process group, one rank a process: NCCL on cards (one card a
process), gloo on the CPU, or a fake group (``launch/dryrun.py``: one
process holds one rank of a world of any size, and every collective
returns at once without moving data).  Axis semantics are the
reference's:

  pod    -- outer data-parallel axis across pods;
  data   -- FSDP / data parallel;
  model  -- sequence-parallel activations, experts, the vocab-parallel
            embedding, sequence-sharded KV for decode (and TP weights
            under serving rules).

Meshes are built outside any ``FakeTensorMode``: ``init_device_mesh``
reads its rank coordinates from real tensors.
"""

from __future__ import annotations

from ..models.layers import ShardingRules


def _group(what: str):
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group: call "
                           f"torch.distributed.init_process_group first")
    return dist


def _device_type(dist) -> str:
    """The mesh's device type: ``cuda`` under NCCL and in a fake group
    (which holds no device), ``cpu`` under gloo."""
    return "cpu" if str(dist.get_backend()).lower() == "gloo" else "cuda"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh over the current process group:
    ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")`` with ``multi_pod``.  The group must have 256 or
    512 ranks (a fake group of that size on one process, for the dry
    run)."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = _group("make_production_mesh")
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size()
    want = 512 if multi_pod else 256
    if n != want:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"production mesh {shape} needs {want} ranks, the "
                         f"process group has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model: int = 1):
    """A ``(data, model)`` = ``(n // model, model)`` mesh over every rank
    of the current process group (``n``: its world size), on ``cpu``
    under gloo and on ``cuda`` otherwise (NCCL, or a fake group).  The
    reference's ``parallelism`` (how many local devices) has no
    counterpart: a rank is a process, and the group fixes how many there
    are."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = _group("make_local_mesh")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not divide into a model axis of "
                         f"{model}")
    return init_device_mesh(_device_type(dist), (n // model, model),
                            mesh_dim_names=("data", "model"))


def _axis_sizes(mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return sizes.get("model", 1), sizes.get("data", 1)


def rules_for_mesh(mesh) -> ShardingRules:
    """Training rules: ZeRO-3 over data x SP / EP / vocab over model
    (weights replicated over model; ``tp`` dims resolve to None)."""
    names = mesh.mesh_dim_names
    ms, ds = _axis_sizes(mesh)
    if "pod" in names:
        return ShardingRules(batch=("pod", "data"), fsdp="data",
                             model="model", model_size=ms, data_size=ds)
    if "data" in names and "model" in names:
        return ShardingRules(batch="data", fsdp="data", model="model",
                             model_size=ms, data_size=ds)
    # a single-axis mesh: no model parallelism
    return ShardingRules(batch=names[0], fsdp=names[0], model=None)


def serve_rules_for_mesh(mesh) -> ShardingRules:
    """Serving rules: Megatron TP over model (``fsdp`` None,
    ``tp_weights``): decode reads only the local weight shard."""
    names = mesh.mesh_dim_names
    ms, ds = _axis_sizes(mesh)
    if "pod" in names:
        return ShardingRules(batch=("pod", "data"), fsdp=None, model="model",
                             tp_weights=True, model_size=ms, data_size=ds)
    return ShardingRules(batch="data", fsdp=None, model="model",
                         tp_weights=True, model_size=ms, data_size=ds)
