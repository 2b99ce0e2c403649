"""Launchers of the port: ``serve`` (batched serving from the command
line), ``train`` (the §IV-C preprocessing application feeding a training
loop, sharded over a ``torchrun`` process group), ``fig9`` (the Fig-9
pipeline over a ``torch.distributed`` process group, started by
``torchrun``), ``mesh`` (the ``("data", "model")`` device mesh and the
training and serving rules), ``shapes`` (the assigned input-shape cells
and their input specs) and ``roofline`` (the card's bound of a measured
query stage, a model's FLOPs per step).  The JAX package's dry-run and
report launchers, its production mesh and the HLO half of its roofline
are not ported yet (ROADMAP item 13.7)."""
