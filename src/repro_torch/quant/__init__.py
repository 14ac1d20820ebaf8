from repro_torch.quant.quantize import (
    QuantizedTensor,
    dequantize,
    dequantize_rows,
    kv_group_size,
    pack_int4,
    pack_int4_rows,
    quantize,
    quantize_q4_0,
    quantize_q8_0,
    quantize_rows,
    quantize_tree,
    unpack_int4,
    unpack_int4_rows,
)

__all__ = [
    "QuantizedTensor", "quantize_q8_0", "quantize_q4_0", "dequantize",
    "quantize", "pack_int4", "unpack_int4", "quantize_tree",
    "kv_group_size", "quantize_rows", "dequantize_rows",
    "pack_int4_rows", "unpack_int4_rows",
]
