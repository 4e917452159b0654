"""Planted: a static matrix without every registered policy."""
POLICIES = ('ideal', 'ref_ab', 'all_bank', 'sarp_pb')


def test_matrix():
    assert POLICIES
