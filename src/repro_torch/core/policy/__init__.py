"""Pluggable refresh/maintenance policies (the paper's policy family as a
first-class API).

  from repro_torch.core.policy import get_policy, list_policies, register_policy
  pol = get_policy("dsarp")        # fresh instance; one per engine run
  pol.select(view)                 # -> [Decision(bank=...), ...]

Importing this package registers the built-in policies (paper family +
the elastic extra + the multirank pair + the subarray-aware hira)."""
from repro_torch.core.policy.base import (ALL_BANKS, ANY_RANK, Decision,
                                    MaintenanceView, PolicyBase,
                                    RefreshPolicy)
from repro_torch.core.policy.ledger import BankLedgerState, MaintenanceLedger
from repro_torch.core.policy.registry import (get_policy, list_policies,
                                        register_policy, resolve_policy)
from repro_torch.core.policy.paper import (AllBankPolicy, DarpPolicy, IdealPolicy,
                                     RoundRobinPolicy)
from repro_torch.core.policy.extras import ElasticPolicy
from repro_torch.core.policy.multirank import (RankAwareDarpPolicy,
                                         StaggeredAllBankPolicy)
from repro_torch.core.policy.subarray import HiraPolicy

__all__ = [
    "ALL_BANKS", "ANY_RANK", "Decision", "MaintenanceView", "PolicyBase",
    "RefreshPolicy", "BankLedgerState", "MaintenanceLedger",
    "get_policy", "list_policies", "register_policy",
    "resolve_policy", "AllBankPolicy", "DarpPolicy", "IdealPolicy",
    "RoundRobinPolicy", "ElasticPolicy", "HiraPolicy",
    "RankAwareDarpPolicy", "StaggeredAllBankPolicy",
]
