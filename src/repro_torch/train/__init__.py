"""Training substrate: optimizer, step assembly, checkpointing,
compression, and the sharding trees ``opt_specs``, ``state_specs`` and
``batch_specs`` (ports ``repro/train``)."""

from .optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                    global_norm, init_opt_state, lr_at, opt_specs)
from .step import (batch_specs, init_train_state, make_train_step,
                   place_state, state_specs, weight_decay_mask)
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .compression import (compressed_all_reduce, dequantize_int8,
                          ef_compressed_all_reduce, quantize_int8)

__all__ = [
    "AdamWConfig", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "lr_at", "opt_specs",
    "batch_specs", "init_train_state", "make_train_step", "place_state",
    "state_specs", "weight_decay_mask",
    "AsyncCheckpointer", "latest_step", "restore", "save",
    "compressed_all_reduce", "dequantize_int8", "ef_compressed_all_reduce",
    "quantize_int8",
]
