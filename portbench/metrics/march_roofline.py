"""march_roofline: the least time the card could take for a frame's march
work over the march kernels' device time per frame. The least time is the
larger of the plain reference's evaluations at the bf16 peak and the bytes
at the HBM peak: the rays' own, and what each evaluation moves beyond the
weights (the model kind's ``bytes_per_eval``: 0 for a dense chain)."""
from .. import work
from ._common import frame_flops, slice_of


def read(run, name):
    sl, flops = slice_of(run), frame_flops(run)
    if not sl or not flops or sl["march_s"] <= 0:
        return None
    w = run["work"]
    moved = w["rays"] * work.RAY_BYTES + w["march_evals"] * w["bytes_per_eval"]
    bound_s = max(flops[0] / work.PEAK_FLOPS, moved / work.PEAK_BYTES_PER_S)
    return 100.0 * bound_s / (sl["march_s"] / sl["frames"])
