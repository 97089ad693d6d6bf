"""Multi-process training and serving: the process mesh and its
collectives (`mesh`), how each rank holds the model's parameters over it
(`sharding`), and independent video streams dealt over the ranks
(`streams`)."""
