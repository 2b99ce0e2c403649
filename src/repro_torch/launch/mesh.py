"""Device meshes and sharding-rule presets (ports ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the processes of
the current process group, one rank a process: NCCL on cards (one card a
process), gloo on the CPU.  Axis semantics are the reference's:

  pod    -- outer data-parallel axis across pods;
  data   -- FSDP / data parallel;
  model  -- sequence-parallel activations, experts, the vocab-parallel
            embedding, sequence-sharded KV for decode (and TP weights
            under serving rules).

``make_production_mesh`` waits for ``dryrun.py`` (ROADMAP item 13.7), its
only reader.
"""

from __future__ import annotations

from ..models.layers import ShardingRules


def make_local_mesh(model: int = 1):
    """A ``(data, model)`` = ``(n // model, model)`` mesh over every rank
    of the current process group (``n``: its world size), on ``cuda``
    under NCCL, else on ``cpu``.  The reference's ``parallelism`` (how
    many local devices) has no counterpart: a rank is a process, and the
    group fixes how many there are."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not divide into a model axis of "
                         f"{model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model, model),
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
