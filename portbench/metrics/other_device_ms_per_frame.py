"""other_device_ms_per_frame: device time of every other operation in the
traced slice (shading, the sorts, packing, copies), per frame."""
from ._common import slice_of


def read(run, name):
    sl = slice_of(run)
    return (sl["device_s"] - sl["march_s"]) * 1e3 / sl["frames"] if sl else None
