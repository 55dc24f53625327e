"""Dense-LM benchmark net (copy of ``repro.configs.lm_bench``): a 2-layer
GQA decoder, attention-dominated (seq 512 >> d_model 64), f32, with
``layer_chunk=1`` so ``bucket_spec()`` exposes one bucket per layer —
embed -> layers0 -> layers1 -> final_norm.  The port's CPU parity net for
LM training."""
from repro_torch.core.types import ArchConfig

CONFIG = ArchConfig(
    name="lm-bench", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab_size=256, tie_embeddings=True,
    scan_layers=True, remat=False,
    param_dtype="float32", layer_chunk=1,
)


def smoke_config() -> ArchConfig:
    return CONFIG  # already CPU-sized
