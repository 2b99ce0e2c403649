"""Launchers of the port: ``serve`` (batched serving from the command
line), ``train`` (the §IV-C preprocessing application feeding a training
loop) and ``roofline`` (the card's bound of a measured query stage).  The
JAX package's mesh, dry-run, shapes and report launchers and the model
half of its roofline are not ported yet (ROADMAP queue 1, item 13.7)."""
