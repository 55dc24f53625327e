"""Paper Table 2 'Small' CNN: 29x29 -> C5@4x4 -> P2 -> C10@5x5 -> P3 -> FC50 -> 10."""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="chaos-small", family="cnn",
    cnn_layers=(
        ("conv", 5, 4),    # 29 -> 26, 5 maps, 4x4 kernel
        ("pool", 2),       # 26 -> 13
        ("conv", 10, 5),   # 13 -> 9
        ("pool", 3),       # 9 -> 3
        ("fc", 50),
    ),
    cnn_input=(29, 29), n_classes=10,
    param_dtype="float32", lr_schedule="decay",
    scan_layers=False, remat=False,
)


def smoke_config() -> ArchConfig:
    return CONFIG  # already CPU-sized
