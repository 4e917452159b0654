"""Good: iterates list_policies() — every registered policy reaches the
port's sweep matrix (RC403)."""
from repro_torch.core.policy import list_policies


def test_sweep_matrix():
    for name in list_policies():
        assert isinstance(name, str)
