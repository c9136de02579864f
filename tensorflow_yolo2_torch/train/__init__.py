"""Training of the port: optimizers, the train step, snapshots, metrics."""
