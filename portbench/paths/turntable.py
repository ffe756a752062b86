"""The reference's ``doABarrelRoll`` (``main.cpp:470-478``): ``rotation_y``
advances ``yaw_step_deg`` a frame from 0, batch by batch, each batch at the
next elevation of ``pitch_deg``. With ``frame: "yaw"`` the scene's
animation frame is the yaw in whole degrees modulo 360.

The same for every seed: a frame's cost swings with its pose (a few grazing
rays that march thousands of steps), so a seeded start would make the work
of a window depend on the seed. The seed still draws the widened weights
and the frames a run checks.
"""
from ..traffic import Pose


def poses(path: dict, traffic: dict, rng):
    batch = int(traffic["batch"])
    pitches = list(path["pitch_deg"])
    step = float(path.get("yaw_step_deg", 1.0))
    animate = path.get("frame", "none") == "yaw"
    i = 0
    while True:
        pitch = float(pitches[(i // batch) % len(pitches)])
        yaw = (i * step) % 360.0
        yield Pose(pitch, yaw, float(int(round(yaw)) % 360) if animate else 0.0)
        i += 1
