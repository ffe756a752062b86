"""host_ms_per_frame.<step>: the host ms of ``render_sequence``'s span
``sequence/enqueue`` (the graph replays or the frames' dispatch) or
``sequence/finish`` (the host checks) a frame, from the program's spans
(``cudaneuralrender_torch.trace``) in the traced run's ``"program"`` part."""
from ..program import program_of


def read(run, name):
    prog = program_of(run)
    span = prog["spans"].get("sequence/" + name.split(".", 1)[1]) if prog else None
    return span["host_ms"] / prog["frames"] if span else None
