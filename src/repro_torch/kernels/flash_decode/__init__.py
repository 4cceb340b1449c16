from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.flash_decode.ref import (combine_partials,
                                                  decode_attention_ref,
                                                  flash_decode_partial_ref)
