"""Multi-process execution of the sweep engine: the launch layer
(``multihost``) and the sharded cell-plan executor (``sweep_shard``)."""
