"""Architecture registry: importing this package registers all configs.

The five LM archs, the four recsys archs, DimeNet and the paper's own
``has-rag`` retrieval step, as the reference registers them.
"""
from repro_torch.configs.base import (REGISTRY, ArchSpec, ShapeSpec,
                                      all_archs, get_arch)

# registration side effects
import repro_torch.configs.lm_archs       # noqa: F401,E402
import repro_torch.configs.dimenet        # noqa: F401,E402
import repro_torch.configs.recsys_archs   # noqa: F401,E402
import repro_torch.configs.has_rag        # noqa: F401,E402
