"""Mesh axes, the sharding rules and their DTensor placements
(counterpart of ``repro/parallel``: ``mesh.py`` and ``sharding.py`` so far)."""
