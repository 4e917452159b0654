"""Good torch tick body: the body returns every plane `closed_state0`
initialises (CU505), and nothing in `*_body` / `*_cond` copies to the
host (DT203)."""
import torch


def closed_state0(cfg, cst):
    z = torch.zeros((cfg.G,), dtype=torch.int32)
    return dict(t=z, remaining=cst["n_req"], finish=z - 1, wbuf=z)


def closed_cond(cst, s):
    return bool((s["remaining"] > 0).any())


def closed_body(cfg, cst, s):
    def bump(x):
        return torch.minimum(x + 1, cst["cap"])

    t = s["t"] + 1
    remaining = torch.clamp(s["remaining"] - 1, min=0)
    finish = torch.where((remaining == 0) & (s["finish"] < 0), t,
                         s["finish"])
    return dict(t=t, remaining=remaining, finish=finish, wbuf=bump(s["wbuf"]))
