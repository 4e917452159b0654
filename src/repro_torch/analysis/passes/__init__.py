"""Built-in analysis passes; importing this package registers them all."""
from repro_torch.analysis.passes import (bitfield, commands,  # noqa: F401
                                         cuda_lint, dtype, purity,
                                         registry_coverage)
