"""march_roofline: the least time the card could take for a frame's march
work (the plain reference's evaluations at the bf16 peak, or the rays'
bytes at the HBM peak, whichever is larger) over the march kernels' device
time per frame."""
from .. import work
from ._common import frame_flops, slice_of


def read(run, name):
    sl, flops = slice_of(run), frame_flops(run)
    if not sl or not flops or sl["march_s"] <= 0:
        return None
    bound_s = max(flops[0] / work.PEAK_FLOPS,
                  run["work"]["rays"] * work.RAY_BYTES / work.PEAK_BYTES_PER_S)
    return 100.0 * bound_s / (sl["march_s"] / sl["frames"])
