"""Good model-side dispatch: CUDA tensors go to the kernel, CPU and meta
tensors to the plain form, any other device raises (CU503)."""
import torch

from repro_torch.kernels import flash_attention as fa

PLAIN_DEVICES = ("cpu", "meta")


def chunked_attention(q, k, v):
    if q.device.type == "cuda":
        return _flash_on_card(q, k, v)
    s = torch.einsum("bqd,bkd->bqk", q, k)
    return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v)


def _flash_on_card(q, k, v):
    return fa.flash_attention_ragged(q, k, v)
