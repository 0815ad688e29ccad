"""Training: optimizers, train step/loop, straggler-tolerant grad agg."""
