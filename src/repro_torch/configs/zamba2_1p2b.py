"""zamba2-1.2b: hybrid, 38L d_model=2048 d_ff=8192 ssm_state=64.

Mamba2 backbone + one SHARED attention block (32H, weights reused) inserted
every 6 layers.  [arXiv:2411.15242; hf]  Sub-quadratic -> runs long_500k.
"""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=32000, ssm_state=64, ssm_conv=4, ssm_expand=2,
    attn_every=6,
    micro_batches=2,  # SSD intra-chunk tensors are seq*chunk-sized (§Perf)
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_conv=4, ssm_expand=2,
        attn_every=2, scan_layers=False, remat=False,
    )
