"""Planted: a static matrix without every registered policy."""
POLICIES = ('ideal', 'ref_ab', 'sarp_pb', 'dsarp')


def test_matrix():
    assert POLICIES
