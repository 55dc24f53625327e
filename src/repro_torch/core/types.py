"""Configuration dataclasses shared by the whole framework.

A copy of ``repro.core.types`` so the port imports nothing of the JAX
package; tests/test_torch_cnn.py holds the two equal field by field.

One ``ArchConfig`` describes any architecture in the zoo (dense GQA
transformer, MLA, MoE, Mamba2 hybrid, RWKV6, enc-dec, VLM backbone, and the
paper's CNNs).  One ``ShapeConfig`` describes an input-shape cell
(train / prefill / decode / long-context-decode).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | mla | moe | hybrid | ssm | encdec | vlm | cnn

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False

    # MLA (minicpm3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0          # hybrid: one shared attn block every N layers

    # enc-dec
    n_enc_layers: int = 0
    enc_frames: int = 1500       # stub audio frontend output length

    # vlm
    n_patches: int = 0           # stub vision frontend output length

    # CNN (paper Table 2): tuples of layer specs
    # conv: ("conv", maps, kernel) / pool: ("pool", kernel) / fc: ("fc", n)
    cnn_layers: Tuple[tuple, ...] = ()
    cnn_input: Tuple[int, int] = (29, 29)
    n_classes: int = 10

    # training knobs
    use_kernel: bool = False     # route hot path through Pallas kernels
    micro_batches: int = 1       # gradient-accumulation steps per batch
    #: LM layer-stack chunking (DESIGN.md §10): split the stacked ``layers``
    #: leaf into ``n_layers / layer_chunk`` per-chunk param keys so
    #: ``bucket_spec()`` exposes embed -> per-chunk -> head buckets.  0 (and
    #: ``n_layers``) keep today's single-stack scan layout; 1 is the fully
    #: unrolled layout; must divide ``n_layers``.
    layer_chunk: int = 0
    param_dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    lr_schedule: str = "constant"  # constant | decay (paper) | wsd (minicpm)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        """Whether the arch supports autoregressive decode shapes."""
        return self.family != "cnn"

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs and sanity checks)."""
        if self.family == "cnn":
            from repro_torch.models import cnn  # local import to avoid cycle
            return cnn.param_count(self)
        d, L, ff, V = self.d_model, self.n_layers, self.d_ff, self.padded_vocab
        dh = self.d_head
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        per_layer = 0
        if self.family == "mla":
            r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
            qk = self.qk_nope_dim + self.qk_rope_dim
            per_layer += d * r_q + r_q * self.n_heads * qk
            per_layer += d * (r_kv + self.qk_rope_dim)
            per_layer += r_kv * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * d
        elif self.family in ("dense", "moe", "vlm", "encdec"):
            per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * dh
            per_layer += self.n_heads * dh * d
        if self.family == "moe":
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
        elif self.family in ("dense", "mla", "vlm", "encdec"):
            per_layer += 3 * d * ff
        if self.family == "hybrid":
            din = d * self.ssm_expand
            H = max(din // 64, 1)
            # per-layer mamba block: in_proj + conv + out_proj
            mamba = (d * (2 * din + 2 * self.ssm_state + H)
                     + self.ssm_conv * din + din * d)
            # shared attention + shared MLP: ONE set of weights, reused
            attn = (d * (self.n_heads + 2 * self.n_kv_heads) * dh
                    + self.n_heads * dh * d)
            per_layer = 0
            n += L * mamba + attn + 3 * d * ff
        if self.family == "ssm":  # rwkv6
            per_layer = d * d * 4 + d * ff * 2 + d * 64 * 6  # tm/td lora-ish
        n += L * per_layer
        if self.family == "encdec":
            enc_layer = d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d + 3 * d * ff
            # cross attention in decoder
            n += self.n_enc_layers * enc_layer + L * (d * (self.n_heads + 2 * self.n_kv_heads) * dh + self.n_heads * dh * d)
        return int(n)

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only top-k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dh = self.d_head
        n = 2 * self.padded_vocab * d
        per_layer = d * (self.n_heads + 2 * self.n_kv_heads) * dh
        per_layer += self.n_heads * dh * d
        per_layer += d * self.n_experts
        per_layer += self.top_k * 3 * d * self.moe_d_ff
        return int(n + L * per_layer)


@dataclasses.dataclass(frozen=True)
class ParamBucket:
    """One ordered, disjoint slice of a model's parameter tree (DESIGN.md §6).

    Every model family exposes ``bucket_spec()`` (``models/api.py``): an
    ordered tuple of buckets whose ``keys`` — top-level param-tree keys —
    form an exact disjoint cover of the tree (property-tested for every
    registered family).  Buckets are the granularity at which gradients are
    exchanged (``SyncStrategy.bucket_exchange``), compressed (per-bucket
    error-feedback residual slices), and applied (per-bucket optimizer-state
    slicing, ``Optimizer.slice_state``): the paper's per-layer non-instant
    update rule walks buckets in reverse-production order, so each bucket's
    exchange + update chains to that bucket's gradient production instead of
    a whole-tree barrier.

    ``index`` is the bucket's position in *production* (forward) order; the
    gradient tape yields buckets at ``index`` descending.
    """
    name: str
    keys: Tuple[str, ...]
    index: int

    def view(self, tree: dict) -> dict:
        """This bucket's slice of a params-shaped (top-level-keyed) tree."""
        return {k: tree[k] for k in self.keys}


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    """CHAOS worker model: N per-device worker instances over a named mesh
    axis (the paper's Phi threads -> forced host devices, DESIGN.md §4).

    ``logical_shards`` decouples the *semantic* batch decomposition from the
    *physical* worker count: the global batch is always split into
    ``logical_shards`` fixed micro-shards whose gradients are combined with
    a fixed-shape reduction, so any ``workers`` dividing ``logical_shards``
    computes bit-identical bsp/chaos updates (worker-count-invariant
    checkpoints; tests/test_worker_scaling.py)."""
    workers: int = 1
    axis: str = "workers"
    logical_shards: int = 8

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")
        if self.logical_shards % self.workers != 0:
            raise ValueError(
                f"workers={self.workers} must divide "
                f"logical_shards={self.logical_shards} so every worker "
                f"owns an equal number of micro-shards")

    @property
    def shards_per_worker(self) -> int:
        return self.logical_shards // self.workers

    def resized(self, workers: int) -> "WorkerConfig":
        """This config at a new worker count (elastic resize, DESIGN.md §7).
        ``logical_shards`` is deliberately carried over unchanged — it is
        the invariant that keeps bsp/chaos gradients bit-exact across the
        membership change; validation re-runs in ``__post_init__``."""
        return dataclasses.replace(self, workers=workers)

    def clamp_workers(self, requested: int) -> int:
        """Largest valid worker count <= ``requested`` (>= 1): elastic
        membership targets (a kill leaving N-1 workers, a grow event) must
        still divide ``logical_shards``, so e.g. losing one of 4 workers
        with 8 logical shards lands on N'=3 -> 2."""
        for n in range(min(requested, self.logical_shards), 0, -1):
            if self.logical_shards % n == 0:
                return n
        return 1

    def validate_batch(self, batch: int) -> None:
        if batch % self.logical_shards != 0:
            raise ValueError(
                f"global batch {batch} must be divisible by "
                f"logical_shards={self.logical_shards} "
                f"(per-shard batch must be uniform for the fixed-shape "
                f"worker reduction)")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
