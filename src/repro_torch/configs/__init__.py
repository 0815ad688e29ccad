"""Architecture registry: importing this package registers every config
of the JAX package (copies of its ``configs/*.py``)."""
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    deepseek_v3_671b,
    gemma2_2b,
    gemma3_12b,
    granite_moe_3b_a800m,
    llava_next_34b,
    mamba2_370m,
    musicgen_large,
    nemotron_4_15b,
    recurrentgemma_9b,
)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_smoke_config,
    list_architectures,
)
