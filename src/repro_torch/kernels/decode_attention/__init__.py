"""One-token attention over a dense or ring KV cache (decode): the CUDA
``decode_attention`` kernel, its plain PyTorch version and the dispatch
between them."""
