"""march_kernel_ms_per_frame: device time of the march kernels
(``march_kernel``, ``march_split_kernel``) in the traced slice, per frame."""
from ._common import slice_of


def read(run, name):
    sl = slice_of(run)
    return sl["march_s"] * 1e3 / sl["frames"] if sl else None
