"""Good: iterates list_policies() — every registered policy reaches the
port's multirank matrix (RC402)."""
from repro_torch.core.policy import list_policies


def test_multirank_matrix():
    for name in list_policies():
        assert isinstance(name, str)
