"""Pluggable refresh/maintenance policies (the paper's policy family as a
first-class API).

  from perfbench.reference.dram.policy import get_policy, list_policies, register_policy
  pol = get_policy("dsarp")        # fresh instance; one per engine run
  pol.select(view)                 # -> [Decision(bank=...), ...]

Importing this package registers the built-in policies (paper family +
the elastic extra + the multirank pair + the subarray-aware hira)."""
from perfbench.reference.dram.policy.base import (ALL_BANKS, ANY_RANK, Decision,
                                    MaintenanceView, PolicyBase,
                                    RefreshPolicy)
from perfbench.reference.dram.policy.ledger import BankLedgerState, MaintenanceLedger
from perfbench.reference.dram.policy.registry import (get_policy, list_policies,
                                        register_policy, resolve_policy)
from perfbench.reference.dram.policy.paper import (AllBankPolicy, DarpPolicy, IdealPolicy,
                                     RoundRobinPolicy)
from perfbench.reference.dram.policy.extras import ElasticPolicy
from perfbench.reference.dram.policy.multirank import (RankAwareDarpPolicy,
                                         StaggeredAllBankPolicy)
from perfbench.reference.dram.policy.subarray import HiraPolicy

__all__ = [
    "ALL_BANKS", "ANY_RANK", "Decision", "MaintenanceView", "PolicyBase",
    "RefreshPolicy", "BankLedgerState", "MaintenanceLedger",
    "get_policy", "list_policies", "register_policy",
    "resolve_policy", "AllBankPolicy", "DarpPolicy", "IdealPolicy",
    "RoundRobinPolicy", "ElasticPolicy", "HiraPolicy",
    "RankAwareDarpPolicy", "StaggeredAllBankPolicy",
]
