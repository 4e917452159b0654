"""Planted: a static matrix without every registered policy."""
POLICIES = ('ref_ab', 'all_bank', 'sarp_pb', 'dsarp')


def test_matrix():
    assert POLICIES
