"""Pose paths, one module per ``path.kind`` of a traffic file: each has
``poses(path, traffic, rng)``, an endless iterator of ``traffic.Pose``."""
