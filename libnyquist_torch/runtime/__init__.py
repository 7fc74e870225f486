"""Runtime of the port: native host library loader, shape bucketing and
the batched synthesis pipelines."""
