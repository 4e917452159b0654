from repro_torch.data.pipeline import SyntheticLMData, Prefetcher

__all__ = ["SyntheticLMData", "Prefetcher"]
