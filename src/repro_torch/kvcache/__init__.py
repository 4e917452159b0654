from repro_torch.kvcache.paged import PagedKVConfig, PagedKVCache, quantize_page, dequantize_page

__all__ = ["PagedKVConfig", "PagedKVCache", "quantize_page", "dequantize_page"]
