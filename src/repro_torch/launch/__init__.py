"""Launchers of the port: ``serve`` (batched serving from the command
line), ``train`` (the §IV-C preprocessing application feeding a training
loop, sharded over a ``torchrun`` process group), ``fig9`` (the Fig-9
pipeline over a ``torch.distributed`` process group, started by
``torchrun``), ``mesh`` (the ``("data", "model")`` device mesh, the
production mesh and the training and serving rules), ``shapes`` (the
assigned input-shape cells and their input specs), ``dryrun`` (every
cell's step at full width on a fake 256- or 512-rank process group,
counted by ``counting``), ``report`` (its tables) and ``roofline`` (the
card's bound of a measured query stage and of a dry-run cell, a model's
FLOPs per step).  ``dryrun`` is run as a module and not imported here.

Exported: ``make_local_mesh``, ``make_production_mesh`` and
``rules_for_mesh`` from ``mesh``.  Importing the package creates no
process group: the two mesh functions ask for the current one when they
are called."""

from .mesh import make_local_mesh, make_production_mesh, rules_for_mesh

__all__ = ["make_local_mesh", "make_production_mesh", "rules_for_mesh"]
