"""The Mamba-2 SSD intra-chunk term (prefill): the CUDA ``ssd_scan``
kernel, its plain PyTorch version and the dispatch between them."""
