"""mfu_pct: a whole frame's work (the plain reference's march and normal
evaluations) at the bf16 peak, as a share of the wall time a frame of the
same frames rendered unprofiled, back to back (``matched_s``)."""
from .. import work
from ._common import frame_flops, matched_frame_s, slice_of


def read(run, name):
    flops, frame_s = frame_flops(run), matched_frame_s(slice_of(run))
    if not flops or not frame_s:
        return None
    return 100.0 * (sum(flops) / work.PEAK_FLOPS) / frame_s
