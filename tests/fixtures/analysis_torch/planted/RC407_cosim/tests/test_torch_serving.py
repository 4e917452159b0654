"""Planted: a static co-sim matrix without the registered scenario."""
COSIM = ("serving_other",)


def test_matrix():
    assert COSIM
