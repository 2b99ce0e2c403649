"""Launchers of the port: ``serve`` (batched serving from the command
line), ``train`` (the §IV-C preprocessing application feeding a training
loop), ``fig9`` (the Fig-9 pipeline over a ``torch.distributed`` process
group, started by ``torchrun``), ``shapes`` (the assigned input-shape cells and their input specs)
and ``roofline`` (the card's bound of a measured query stage, a model's
FLOPs per step).  The JAX package's mesh, dry-run and report launchers and
the HLO half of its roofline are not ported yet (ROADMAP queue 1, item
13.7: they lower onto a mesh, item 13.6)."""
