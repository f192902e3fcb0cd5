"""Training steps, process groups and the (data, model) mesh, tensor-
parallel vocoder sharding, and the multi-process launcher and dry run."""
