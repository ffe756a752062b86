"""Driver loops, one module per ``delivery`` of a traffic file. Each has
``Driver(cnr, params, rcfg, stream, traffic)`` with ``run(seconds=,
keeper=, trace=, warm=)``, which returns the window record (``start``,
``end``, ``frames``: pose, program ``stats``, ``done`` host time; the
traced ``slice``), and ``to_bytes(image)``, a served frame as the uint8
[H, W, 4] bytes the check compares (row 0 = the image's bottom)."""
