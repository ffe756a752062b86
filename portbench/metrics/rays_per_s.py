"""rays_per_s: pixels of every frame completed in the window over the time
from the window's start to the return of its last batch; host clock."""


def read(run, name):
    win = run["window"]
    if not win["frames"]:
        return None
    return run["pixels"] * len(win["frames"]) / (win["end"] - win["start"])
