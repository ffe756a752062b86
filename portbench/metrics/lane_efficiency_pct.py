"""lane_efficiency_pct.<phase>: 100 x the steps the rays of the frame's
``coarse`` or ``refine`` march calls marched over the lane-steps their
launches held (a ray per thread: each warp for its deepest ray; a ray per
warp: each ray's steps), from the program's counters
(``megakernel._count_march``) in the traced run's ``"program"`` part."""
from ..program import counter_sum, program_of


def read(run, name):
    prog = program_of(run)
    if not prog:
        return None
    phase = name.split(".", 1)[1]
    slots = counter_sum(prog, phase, "slots")
    return 100.0 * counter_sum(prog, phase, "useful") / slots if slots else None
