"""Good: iterates list_serving_scenarios() — every serving scenario
reaches the port's co-sim matrix (RC407)."""
from repro_torch.core.refresh.scenarios import list_serving_scenarios


def test_every_serving_scenario_replays():
    for name in list_serving_scenarios():
        assert name.startswith("serving_")
