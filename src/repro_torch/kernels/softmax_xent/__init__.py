from repro_torch.kernels.softmax_xent.kernel import (XentLocalStats,
                                                     xent_local_stats)
from repro_torch.kernels.softmax_xent.ref import (combine_stats,
                                                  local_stats_ref,
                                                  softmax_xent_ref)
