"""The LM substrate's serving path: layers, attention, the block stack
(``lm``) and prefill/decode (``decode``)."""
