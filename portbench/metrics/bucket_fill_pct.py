"""bucket_fill_pct.refine: 100 x the lanes active at the entry of the
frame's refine march calls over the lanes of their buckets, from the
program's counters (``megakernel._count_march``) in the traced run's
``"program"`` part."""
from ..program import counter_sum, program_of


def read(run, name):
    prog = program_of(run)
    if not prog:
        return None
    phase = name.split(".", 1)[1]
    lanes = counter_sum(prog, phase, "lanes")
    return 100.0 * counter_sum(prog, phase, "active_in") / lanes if lanes else None
