from repro_torch.core.policy.registry import (list_policies,  # noqa: F401
                                        register_policy)
