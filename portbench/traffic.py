"""The general traffic generator: poses from a traffic file and a seed.

A traffic file (``portbench/traffic/<name>.json``) holds parameters only;
this module turns them into an endless stream of poses, the same stream for
the same seed. The file's ``path.kind`` names the module under
``portbench/paths/`` whose ``poses(path, traffic, rng)`` yields them, and
its ``delivery`` names the driver loop under ``portbench/mixes/``
(``spec.mix``).
"""
from __future__ import annotations

import importlib
from typing import Iterator, NamedTuple

import numpy as np


class Pose(NamedTuple):
    rotation_x: float
    rotation_y: float
    frame: float

    def as_dict(self) -> dict:
        return dict(rotation_x=self.rotation_x, rotation_y=self.rotation_y, frame=self.frame)


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named use of ``seed`` (any whole number)."""
    tag = int.from_bytes(stream.encode(), "little")
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), int(seed) >> 64, tag])


def path_kind(kind: str):
    """The module of a pose path's kind, found by name."""
    return importlib.import_module(f"portbench.paths.{kind}")


def poses(traffic: dict, seed: int) -> Iterator[Pose]:
    """The endless pose stream of ``traffic`` under ``seed``."""
    path = traffic["path"]
    return path_kind(path["kind"]).poses(path, traffic, rng_for(seed, "poses"))


def take(stream: Iterator[Pose], n: int) -> list:
    return [next(stream) for _ in range(n)]
