"""phase_ms_per_frame.<phase>: the device ms of the staged frame's span
``frame/<phase>`` (coarse, refine, shade, restore) a frame, from the
program's own marks (``cudaneuralrender_torch.trace``) in the traced run's
``"program"`` part (``portbench/program.py``); through CUDA graphs too."""
from ..program import device_ms, program_of


def read(run, name):
    prog = program_of(run)
    ms = device_ms(prog, "frame/" + name.split(".", 1)[1]) if prog else None
    return None if ms is None else ms / prog["frames"]
