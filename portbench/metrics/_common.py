"""What several readers share."""
from __future__ import annotations


def slice_of(run):
    sl = run.get("slice")
    return sl if sl and sl["frames"] else None


def frame_flops(run):
    """The plain reference's FLOPs for one frame's march and for its
    normals, from the traced run's work count."""
    w = run.get("work")
    if not w:
        return None
    march = w["march_evals"] * w["flops_per_eval"]
    return march, w["hits"] * 4 * w["flops_per_eval"]


def matched_frame_s(sl):
    """The wall time a frame of the slice's frames rendered unprofiled, or
    None."""
    if not sl or not sl.get("matched_frames"):
        return None
    return sl["matched_s"] / sl["matched_frames"]
