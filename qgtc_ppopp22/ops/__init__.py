from qgtc_ppopp22.ops.quantize import quantize, requantize, dequantize_levels
from qgtc_ppopp22.ops.bitpack import (
    BitTensor,
    pack_bits,
    unpack_bits,
    val2bit,
    bit2val,
    to_digits,
)
from qgtc_ppopp22.ops.bitgemm import bitmm_to_bits, bitmm_to_int, flops_convention
from qgtc_ppopp22.ops.digits import (
    DigitTensor,
    to_digit_tensor,
    digit_pack,
    digit_unpack,
)
from qgtc_ppopp22.ops.digitmm import (
    digitmm_to_digits,
    digitmm_to_f32,
    digitmm_to_i32,
)
from qgtc_ppopp22.ops.packmm import (
    PackedTensor,
    pack_rows,
    unpack_rows,
    pack_digit_tensor,
    packmm_to_f32,
    packmm_to_digits,
    packmm_to_packed,
    build_tile_map_packed_np,
)
