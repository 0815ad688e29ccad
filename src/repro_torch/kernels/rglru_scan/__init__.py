"""The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t`` (prefill): the
CUDA ``rglru_scan`` kernel, its plain PyTorch version and the dispatch
between them."""
