from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_dense_ref,
                                                     flash_attention_ref,
                                                     flash_attention_triangular)
