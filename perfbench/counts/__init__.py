"""Frozen yardsticks: published peaks of the card, and the operations and
bytes each measured kernel and step needs, computed from shapes and
outputs, never from the program's own counts."""
