"""gather_roofline.<span>: the least time the card's L2 could take to serve
the table entries gathered inside the program's span ``frame/<span>`` (the
name's dots as slashes: ``coarse``, ``refine``, ``shade.encode``), as a
share of that span's device time: 100 x (the counters ``*.gathers`` under
the span x 8 B / ``L2_BYTES_PER_S``) over it, from the program's counters
and marks in the traced run's ``"program"`` part. A gather is one table
entry of two float32 features: the march calls count ``march.gathers``
(the model's ``gathers_per_eval`` a useful step: 8 corners a level of a
hash-grid SDF), the shading encoding ``encode.gathers`` (its forward's
points, each needing its entries once). A program that counts none (a dense
chain, or a program without the counters) reads None.

The roof is L2's, not HBM's: the hash grid's table (48.8 MB) nearly fits
the H100's 50 MB L2, and gathers from it passed HBM's 3.35 TB/s (108%).
``L2_BYTES_PER_S`` is ``python3 -m portbench.l2_bandwidth``'s
``l2_bytes_per_s`` on an NVIDIA H100 80GB HBM3 at 700 W: the fastest
L2-resident read it measured, coalesced 8-byte loads that bypass L1 over an
8 MB buffer (7.08 TB/s over 32 MB; scattered 8-byte loads 0.77-1.08 TB/s;
a 128 MB stream 3.59-3.88 TB/s). A kernel whose lanes share entries
through L1 can still pass it."""
from ..program import device_ms, program_of

#: Bytes of one gathered table entry: two float32 features.
GATHER_BYTES = 8
#: The card's L2 read bandwidth (``portbench.l2_bandwidth``).
L2_BYTES_PER_S = 8.487890562272016e12


def read(run, name):
    prog = program_of(run)
    if not prog:
        return None
    path = "frame/" + name.split(".", 1)[1].replace(".", "/")
    gathers = sum(v for k, v in prog["counters"].items()
                  if k.endswith(".gathers") and (k.startswith(path + "/")
                                                 or "/" + path + "/" in k))
    ms = device_ms(prog, path)
    if not gathers or not ms:
        return None
    return 100.0 * (gathers * GATHER_BYTES / L2_BYTES_PER_S) / (ms / 1e3)
