"""Runtime of the port: native host library loader, shape bucketing and
the batched replay and synthesis pipelines."""
