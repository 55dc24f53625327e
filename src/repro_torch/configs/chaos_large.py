"""Paper Table 2 'Large' CNN.

C20@4x4 -> P1 -> C60@5x5 -> P2 -> C100@6x6 -> P -> FC150 -> 10.
(29->26 conv, 26->26 pool1x1, 26->22 conv, 22->11 pool2, 11->6 conv, 6->3 pool)

NOTE: Table 2 lists the last pool as 3x3/"map size 2x2" but also 900 neurons
and 135,150 FC weights, which requires a 3x3x100 pool output.  We use a 2x2
pool (6->3) so the parameter count matches the paper's exactly (383,160).
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="chaos-large", family="cnn",
    cnn_layers=(
        ("conv", 20, 4),    # 29 -> 26
        ("pool", 1),        # 26 -> 26 (paper's 1x1 'pool')
        ("conv", 60, 5),    # 26 -> 22
        ("pool", 2),        # 22 -> 11
        ("conv", 100, 6),   # 11 -> 6
        ("pool", 2),        # 6 -> 3  (see NOTE above)
        ("fc", 150),
    ),
    cnn_input=(29, 29), n_classes=10,
    param_dtype="float32", lr_schedule="decay",
    scan_layers=False, remat=False,
)


def smoke_config() -> ArchConfig:
    return CONFIG
