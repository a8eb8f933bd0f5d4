"""Serving-side core of the port: the packed weight format."""
from .packing import (  # noqa: F401
    PackedWeight,
    pack_from_float,
    pack_model_params,
    pack_quantized,
    pack_stacked_from_float,
    packable,
    packed_leaves,
    scale_row,
    truncate_packed,
    unpack_bits_axis0,
    unpack_to_float,
)
