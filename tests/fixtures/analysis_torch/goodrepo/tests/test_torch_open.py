"""Good: iterates list_policies() — every registered policy reaches the
port's subarray matrix (RC406)."""
from repro_torch.core.policy import list_policies


def test_subarray_matrix():
    for name in list_policies():
        assert isinstance(name, str)
