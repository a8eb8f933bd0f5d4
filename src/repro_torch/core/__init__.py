"""BSQ core of the port: the bit representation, its STE, regulariser,
re-quantisation, scheme and packed export, and the packed serving format."""
from .bitrep import (  # noqa: F401
    BitRep,
    accumulate_planes,
    decompose,
    effective_bits,
    extract_scale,
    int_to_planes,
    planes_to_int,
    reconstruct_exact,
)
from .bsq import (  # noqa: F401
    BSQConfig,
    default_quant_predicate,
    export_packed,
    extract_scheme,
    init_bitreps,
    merge_params,
    partition_params,
    reconstruct,
    regularizer,
    requantize_tree,
    total_quantized_params,
)
from .packing import (  # noqa: F401
    PackedWeight,
    abstract_packed,
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
from .regularizer import bgl, bit_group_norms, memory_reweighed_bgl  # noqa: F401
from .requant import (  # noqa: F401
    forward_value,
    grow_headroom,
    requantize_dynamic,
    requantize_static,
    verify_equivalence,
)
from .scheme import QuantScheme, scheme_from_reps  # noqa: F401
from .ste import (  # noqa: F401
    act_quantize,
    bitrep_forward,
    dorefa_weight,
    pact_act_quantize,
    relu6_act_quantize,
    ste_round,
    uniform_quantize,
)
