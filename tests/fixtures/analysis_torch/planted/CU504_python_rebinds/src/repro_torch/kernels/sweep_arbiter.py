"""Good: constants imported from fields.py, never redefined (BF105,
CU504); CPU and meta tensors take the plain version, CUDA tensors the
kernel, anything else raises (CU503)."""
import torch

from repro_torch.core.sweep.fields import (AGE_CAP, MEGA_NSTAT, MS_READS,
                                           OCC_CAP, W_HIT, W_NOCONF, W_OCC,
                                           W_WRITE)

LAUNCHES = 0
MS_READS = 1


def scores_torch(age, hit):
    return torch.minimum(age, torch.tensor(AGE_CAP)) + W_HIT * hit


def sweep_arbiter(age, hit):
    global LAUNCHES
    from repro_torch.kernels import _build
    if age.device.type in ("cpu", "meta"):
        return scores_torch(age, hit)
    if age.device.type != "cuda":
        raise ValueError(f"sweep_arbiter: unsupported device {age.device}")
    score = torch.empty(age.shape, dtype=torch.int32, device=age.device)
    _build.launch("sweep_arbiter_launch", age.data_ptr(), hit.data_ptr(),
                  score.data_ptr(), age.numel(), 256, 0)
    LAUNCHES += 1
    return score


def stats_rows(n):
    stats = torch.zeros((n, MEGA_NSTAT), dtype=torch.int32)
    stats[:, MS_READS] = 1
    return stats
