"""Log-bin histogram sketch: the CUDA ``hist_accum`` kernel, its plain
PyTorch version and the sketch geometry / percentile read-out."""
