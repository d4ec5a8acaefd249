from zgml.quant.blocks import (  # noqa: F401
    QK,
    Q4_0_BLOCK_BYTES,
    Q8_0_BLOCK_BYTES,
    quantize_q4_0,
    quantize_q8_0,
    dequantize_q4_0,
    dequantize_q8_0,
    f16_bytes_to_f32,
    quantization_error,
)
from zgml.quant.repack import (  # noqa: F401
    PackedWeight,
    repack_q4_0,
    repack_q8_0,
    repack_gguf_tensor,
    dequant_packed,
)
