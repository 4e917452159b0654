_POLICIES = {}


def register_policy(name, factory=None):
    if factory is not None:
        _POLICIES[name] = factory
        return factory

    def deco(cls):
        _POLICIES[name] = cls
        return cls

    return deco


def list_policies():
    return sorted(_POLICIES)
