from repro_torch.kernels.ssd_scan.kernel import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref, ssd_decode_step,
                                              ssd_sequential_ref)
