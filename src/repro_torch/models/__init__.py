from repro_torch.models.dims import Dims, make_dims
from repro_torch.models import api

__all__ = ["Dims", "make_dims", "api"]
