"""Good: select() treats the view as read-only (PP302); the policy
layer imports no engine code (PP303); every registration's class is
classifiable (RC404) and both SARP-trait spellings — class attribute
and lambda keyword — reach the subarray matrix (RC406)."""
from repro_torch.core.policy.registry import register_policy


@register_policy("ideal")
class IdealPolicy:
    ideal = True

    def select(self, view):
        del view
        return []


class AllBankPolicy:
    ideal = False

    def select(self, view):
        view.due.clear()
        return []


register_policy("ref_ab", AllBankPolicy)
register_policy("all_bank", lambda **kw: AllBankPolicy(**kw))


class SarpPolicy:
    ideal = False
    sarp = True

    def __init__(self, sarp=True):
        del sarp

    def select(self, view):
        del view
        return []


register_policy("sarp_pb", SarpPolicy)
register_policy("dsarp", lambda **kw: SarpPolicy(sarp=True, **kw))
