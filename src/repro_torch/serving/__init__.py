from repro_torch.serving.engine import (EngineConfig, EngineCore, QueueFull,
                                  Request, RequestHandle, RequestMetrics,
                                  RequestState, ServeConfig, ServingEngine)
from repro_torch.serving.cosim import (CoSimConfig, CoSimRun, CoSimTimeout,
                                 bit_identical_replay, compare_policies,
                                 make_stub_forwards, run_cosim)

__all__ = [
    "EngineConfig", "EngineCore", "QueueFull", "RequestHandle",
    "RequestMetrics", "RequestState",
    # serving <-> DRAM co-sim
    "CoSimConfig", "CoSimRun", "CoSimTimeout", "bit_identical_replay",
    "compare_policies", "make_stub_forwards", "run_cosim",
    # legacy shim spellings
    "ServeConfig", "ServingEngine", "Request",
]
