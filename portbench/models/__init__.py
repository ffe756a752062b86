"""Model kinds, one module per ``model`` of a configuration file (absent:
``dense_relu``), found by name (``spec.model``). Each defines:

  * ``make(config, root, seed)``: the configuration's weights as plain
    arrays, made from ``seed``; opaque to the harness, handed to both sides;
  * ``program(cnr, weights, device)``: what the traffic's driver loop hands
    to the program's render calls as its parameters;
  * ``reference_net(weights, device)``: the plain reference's distance
    function, points [N, num_inputs] to distances [N] in float32 with TF32
    off, whose ``emulate_tf32`` attribute the TF32 control switches on (on a
    device without TF32);
  * ``flops_per_eval(config)``: the plain reference's FLOPs for one SDF
    evaluation;
  * ``bytes_per_eval(config)``: the bytes one evaluation must move beyond
    the weights (0 where the weights are all it reads).

A kind imports nothing of the program (``program`` is handed it) and
nothing of JAX or the JAX package."""
