"""Causal GQA flash attention (prefill): the CUDA ``flash_attention``
kernel, its plain PyTorch version and the dispatch between them."""
