from repro_torch.checkpoint.engine import (CheckpointEngine, CheckpointConfig,
                                           latest_step)

__all__ = ["CheckpointEngine", "CheckpointConfig", "latest_step"]
