"""Plain PyTorch references, one file per architecture family, named by
a configuration's ``reference`` key. They import nothing of the program
(``repro_torch``) and no JAX; they take the weights the benchmark drew,
by name, and work out the cache and the routing themselves."""
