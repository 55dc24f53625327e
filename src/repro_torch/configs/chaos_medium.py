"""Paper Table 2 'Medium' CNN: C20@4x4 -> P2 -> C40@5x5 -> P3 -> FC150 -> 10."""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="chaos-medium", family="cnn",
    cnn_layers=(
        ("conv", 20, 4),   # 29 -> 26
        ("pool", 2),       # 26 -> 13
        ("conv", 40, 5),   # 13 -> 9
        ("pool", 3),       # 9 -> 3
        ("fc", 150),
    ),
    cnn_input=(29, 29), n_classes=10,
    param_dtype="float32", lr_schedule="decay",
    scan_layers=False, remat=False,
)


def smoke_config() -> ArchConfig:
    return CONFIG
