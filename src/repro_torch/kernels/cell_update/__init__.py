"""The sweep engine's per-chunk cell update: the CUDA ``cell_update``
kernel, its plain PyTorch version and the dispatch between them."""
