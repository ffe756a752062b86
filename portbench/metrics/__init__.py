"""One reader per metric family: ``read(run, name)`` returns the metric's
value from the run record, or None where the run has nothing to read.

The run record (``harness.run_cell``) holds ``setup_s``, the ``window``
(its ``start``, ``end`` and ``frames``: pose, ``stats`` counters from the
program, ``done`` host time), ``pixels`` a frame, the traced ``slice``
(``work.read_trace``, with ``matched_s`` and ``matched_frames``: the wall
time and the frames of the same poses rendered unprofiled, and the
program's own spans and counters under ``program``: ``program.run``) and
the ``work`` count (``work.count_work``, with the model kind's
``flops_per_eval`` and ``bytes_per_eval``)."""
