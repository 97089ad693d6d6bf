"""Multi-process training: the process mesh and its collectives (`mesh`),
and how each rank holds the model's parameters over it (`sharding`)."""
