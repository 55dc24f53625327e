"""rwkv6-1.6b (Finch): attention-free, 24L d_model=2048 d_ff=7168 vocab=65536.

Data-dependent decay linear recurrence. [arXiv:2404.05892; unverified]
Sub-quadratic -> runs long_500k.
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, d_head=64,
    d_ff=7168, vocab_size=65536,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, d_head=16,
        d_ff=128, vocab_size=256, scan_layers=False, remat=False,
    )
