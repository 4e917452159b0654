"""Good: classify() covers every registered class; no dead entries
(RC404/RC405); engines never branch on registry names (PP301)."""
from repro_torch.core.policy.paper import AllBankPolicy, SarpPolicy

(KIND_IDEAL, KIND_AB, KIND_SARP, KIND_CUSTOM) = range(4)


def classify(pol, budget):
    if pol.ideal:
        return KIND_IDEAL, {}
    if type(pol) is AllBankPolicy:
        return KIND_AB, {"budget": budget}
    if type(pol) is SarpPolicy:
        return KIND_SARP, {}
    return KIND_CUSTOM, {}
