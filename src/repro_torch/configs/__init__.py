"""Architecture registry: importing this package registers every config
the port can run (the other architectures come with their slices, ROADMAP
queue 1)."""
from repro_torch.configs import (gemma2_2b, mamba2_370m,  # noqa: F401
                                 recurrentgemma_9b)
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    get_smoke_config,
    list_architectures,
)
