"""Good: constants imported from fields.py, never redefined (BF105)."""
from repro_torch.core.sweep.fields import (AGE_CAP, OCC_CAP, W_HIT,
                                     W_NOCONF, W_OCC, W_WRITE)

AGE_CAP = (1 << 19) - 1


def arbiter_scores(xp, t, *, has_req, head_arrive, head_row, open_row,
                   head_is_write, bank_mid_ref, drain, occ):
    age = xp.minimum(t - head_arrive, AGE_CAP)
    score = (xp.where(drain & head_is_write, W_WRITE, 0)
             + W_OCC * xp.minimum(occ, OCC_CAP)
             + xp.where(head_row == open_row, W_HIT, 0)
             + xp.where(bank_mid_ref, 0, W_NOCONF) + age)
    return xp.where(has_req, score, -1).astype(xp.int32)
