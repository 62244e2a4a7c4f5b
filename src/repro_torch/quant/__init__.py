from .ptq import QUANT_KEYS, quantize_params
from .qarray import (QTensor, dequant_counters, dequant_rows, dequantize,
                     quantize, reset_dequant_counters, unpack_int4)

__all__ = ["QUANT_KEYS", "QTensor", "dequant_counters", "dequant_rows",
           "dequantize", "quantize", "quantize_params",
           "reset_dequant_counters", "unpack_int4"]
