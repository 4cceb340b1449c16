"""The plain data-parallel AdamW update (port of the ``plain_dp_adamw_update``
half of ``repro/optim/zero.py``) at dp = tp = 1.

The ZeRO half (flat master shards, ``zero=True``) is ROADMAP Queue 1 item 9;
the all-reduces of dp or tp > 1 need the multi-device substrate (item 8).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update


def plain_dp_adamw_update(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
                          grads: Dict[str, torch.Tensor], state: AdamWState,
                          lr_scale: float = 1.0
                          ) -> Tuple[AdamWState, torch.Tensor]:
    """Global-norm clip, then AdamW on every param, in place, in the order
    of ``params`` (the reference tree's). Returns the new state and the
    pre-clip global norm.

    At dp = tp = 1 the reference's mean over dp and its psums are the
    identity and its ``replication`` divisors (model-axis copies of a leaf)
    are all 1, so this is :func:`adamw_update`."""
    return adamw_update(cfg, params, grads, state, lr_scale)
