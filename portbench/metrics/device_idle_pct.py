"""device_idle_pct: 1 - the slice's device busy time a frame over the wall
time a frame of the same frames rendered unprofiled, back to back
(``matched_s``)."""
from ._common import matched_frame_s, slice_of


def read(run, name):
    sl = slice_of(run)
    frame_s = matched_frame_s(sl)
    if not frame_s:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["frames"] / frame_s)
