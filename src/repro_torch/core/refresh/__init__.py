from repro_torch.core.refresh.timing import DramTiming, DENSITIES
from repro_torch.core.refresh.workload import (TraceWorkload, Workload,
                                         make_workload, quantize_streams,
                                         trace_workload)
from repro_torch.core.refresh.scenarios import (ClosedDemand, ServingArrivals,
                                          Trace,
                                          list_closed_scenarios,
                                          list_scenarios,
                                          list_serving_scenarios,
                                          make_closed_demand,
                                          make_closed_workload,
                                          make_serving_arrivals, make_trace,
                                          register_closed_scenario,
                                          register_scenario,
                                          register_serving_scenario)
from repro_torch.core.refresh.sim import (DramSim, SimResult, POLICIES,
                                    energy_proxy, run_policy)

__all__ = ["DramTiming", "DENSITIES", "Workload", "TraceWorkload",
           "make_workload", "trace_workload",
           "quantize_streams", "Trace", "list_scenarios", "make_trace",
           "register_scenario", "ClosedDemand", "list_closed_scenarios",
           "make_closed_demand", "make_closed_workload",
           "register_closed_scenario", "ServingArrivals",
           "list_serving_scenarios", "make_serving_arrivals",
           "register_serving_scenario", "DramSim", "SimResult", "POLICIES",
           "energy_proxy", "run_policy"]
