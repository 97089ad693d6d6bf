"""Model kinds. A configuration file's `model` names its kind, the module
benchmark/models/<model>.py, which gives:

- `spec(cfg)`: every tensor of the model, (name, shape, rule), for
  `weights.generate`;
- `port_config(cfg)`: the program's configuration and precision;
- `build(ctx)`: (model on the device holding `weights.generate`'s tensors
  for the seed, the program's configuration, its precision);
- `narrow(cfg)`: the configuration cut for runs on the CPU in tests;
- `reference(weights, cfg, **rounding)`: the plain reference on those
  weights, in fp32 or with `bf16=True` or `lowp=True` rounding.

A kind's module imports the program only inside `port_config` and
`build`: the weights and the reference load nothing of it."""

CONTRACT = ("spec", "port_config", "build", "narrow", "reference")
