from .kv import (KV_DTYPES, KV_QMAX, KV_SCALE_FLOOR, dequant_scale,
                 dequantize_page, quant_store_rows, quantize_page)

__all__ = ["KV_DTYPES", "KV_QMAX", "KV_SCALE_FLOOR", "dequant_scale",
           "quantize_page", "dequantize_page", "quant_store_rows"]
