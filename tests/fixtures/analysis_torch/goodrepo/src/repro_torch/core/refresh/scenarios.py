"""Scenario registries (fixture corpus).

Mirrors the real module's serving-scenario registry just enough for the
registry-coverage pass (RC407): one decorator-form registration that the
fixture co-sim matrix covers by iterating ``list_serving_scenarios()``.
"""

_SERVING_SCENARIOS = {}


def register_serving_scenario(name, fn=None):
    def deco(f):
        _SERVING_SCENARIOS[name] = f
        return f
    if fn is not None:
        _SERVING_SCENARIOS[name] = fn
        return fn
    return deco


def list_serving_scenarios():
    return sorted(_SERVING_SCENARIOS)


@register_serving_scenario("serving_fixture")
def serving_fixture(n_requests, rs):
    return [0] * n_requests
