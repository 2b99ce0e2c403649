"""Launchers of the port: ``serve`` (batched serving from the command
line).  The JAX package's mesh, dry-run, roofline and training launchers
are not ported yet (ROADMAP queue 1, item 13)."""
