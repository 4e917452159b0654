"""Percent of the traced window in which no kernel ran on the card."""
from perfbench.metrics import idle_share


def read(data):
    return idle_share(data)
