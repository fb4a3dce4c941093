"""Device-memory planning for the solvers (the sharded paths are not
ported yet, see ROADMAP.md)."""
