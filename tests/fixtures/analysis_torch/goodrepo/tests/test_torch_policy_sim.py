"""Good: iterates list_policies() — every registered policy reaches the
port's conformance matrix (RC401)."""
from repro_torch.core.policy import list_policies


def test_conformance_matrix():
    for name in list_policies():
        assert isinstance(name, str)
