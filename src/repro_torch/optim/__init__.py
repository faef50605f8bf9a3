from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    CompressionState,
    adamw_update,
    compress_decompress,
    compressed_grads,
    global_norm,
    init_adamw,
    init_compression,
    lr_schedule,
)

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "CompressionState",
    "adamw_update",
    "compress_decompress",
    "compressed_grads",
    "global_norm",
    "init_adamw",
    "init_compression",
    "lr_schedule",
]
