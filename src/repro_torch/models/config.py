"""Model configuration for the 10 assigned architectures.

One ModelConfig describes any member of the supported families:
dense / moe / ssm (xLSTM) / hybrid (Mamba2+shared attn) / vlm / audio
(enc-dec).  Frontends for [vlm]/[audio] are stubs: `input_specs()` supplies
precomputed patch/frame embeddings per the assignment.

A copy of `repro.models.config` for the PyTorch port, plus `torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    first_dense: int = 0          # first k layers use a dense FFN instead
    d_first_dense: int = 0
    token_chunk: int = 0          # process tokens in chunks of this size
                                  # (bounds the (T*k, d) dispatch buffers)
    # the port's own options (the reference has neither; the defaults are
    # its behaviour)
    dropless: bool = False        # every assignment runs: sorted by expert,
                                  # grouped GEMMs over variable row counts
    norm_topk: bool = True        # renormalise the top-k gates to sum to 1


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512            # compressed kv dim (cached at decode)
    q_lora: int = 1536
    d_nope: int = 128             # per-head non-rotary q/k dim
    d_rope: int = 64              # shared rotary key dim
    d_v: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    d_head: int = 64
    chunk: int = 256
    conv_width: int = 4


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 6          # layer i is sLSTM if i % slstm_every == 0
    chunk: int = 256              # mLSTM chunk length
    proj_factor_m: float = 2.0    # mLSTM up-projection
    proj_factor_s: float = 1.3334 # sLSTM FFN factor
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0               # defaults to d_model // n_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0    # chatglm-style 2d rope: rotate this fraction
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 0           # hybrid: shared attn block every k layers
    qk_norm: bool = False         # RMSNorm on the flat q and k projections
                                  # before RoPE (OLMoE; the port's own option)
    # enc-dec (audio) --------------------------------------------------------
    n_enc_layers: int = 0
    enc_len: int = 1024           # frame embeddings from the stub frontend
    # vlm --------------------------------------------------------------------
    n_patches: int = 0            # patch embeddings from the stub frontend
    # numerics / performance -------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "none"           # none|dots|full  (activation checkpointing)
    fsdp: bool = False            # additionally shard weights over data axis
    train_microbatches: int = 1   # gradient-accumulation microbatches
    layout: str = "tp"            # "tp": model axis = TP/EP | "fsdp": model
                                  # axis joins data (pure ZeRO-3, no TP)
    attn_block_q: int = 512       # chunked-attention query block
    attn_block_kv: int = 1024
    logits_chunk: int = 0         # vocab-chunked loss (0 = off)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert not (self.moe and self.layout == "fsdp"), \
            "MoE archs need the model axis for expert parallelism"

    # -- family predicates ---------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a tile boundary so the vocab dim can
        shard over the model axis (151655 etc. are not divisible by 16;
        unsharded logits replicate ~20 GB/device — EXPERIMENTS.md)."""
        return -(-self.vocab // 128) * 128

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context?  (SSM/hybrid: yes.)"""
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6ND roofline math) -----------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":        # xLSTM
            x = self.xlstm
            per_m = int(2 * d * d * x.proj_factor_m) + \
                int(3 * d * d * x.proj_factor_m / 2) + 8 * d
            per_s = 4 * d * d + int(2 * d * d * x.proj_factor_s) + 8 * d
            n_s = len([i for i in range(L) if i % x.slstm_every == 0])
            return emb + n_s * per_s + (L - n_s) * per_m
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            per = 2 * d * d_in + d_in * d + 2 * d_in * s.d_state  # approx
            attn = 4 * d * d + 3 * d * self.d_ff
            n_attn = L // max(self.attn_every, 1)
            return emb + L * per + attn + n_attn * 0  # shared block params once
        # attention side
        if self.mla:
            m = self.mla
            attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.d_nope + m.d_rope)
                    + d * (m.kv_lora + m.d_rope)
                    + m.kv_lora * self.n_heads * (m.d_nope + m.d_v)
                    + self.n_heads * m.d_v * d)
        else:
            attn = d * self.n_heads * self.d_head + \
                2 * d * self.n_kv * self.d_head + self.n_heads * self.d_head * d
        if self.moe:
            mo = self.moe
            n_routed = mo.top_k if active_only else mo.n_experts
            ffn = (n_routed + mo.n_shared) * 3 * d * mo.d_expert
            dense_ff = mo.first_dense * 3 * d * mo.d_first_dense
            ffn_total = (L - mo.first_dense) * ffn + dense_ff
        else:
            ffn_total = L * 3 * d * self.d_ff
        total = emb + L * attn + ffn_total
        if self.is_encdec:  # encoder layers: self-attn + ffn; decoder adds cross
            enc = self.n_enc_layers * (attn + 3 * d * self.d_ff)
            total += enc + L * attn  # cross-attention in each decoder layer
        return total


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# The port's bound on a float32 temporary of one param leaf, in elements: a
# larger leaf is drawn at init (`layers._init`) a block of leading-axis
# (layer) slices at a time, so a full-width MoE model's stacked experts need
# one layer's f32 copies at a time, not the whole stack's.
SLICE_ELEMS = 1 << 27


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype name ("bfloat16" / "float32") to a torch dtype."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(_TORCH_DTYPES)}") from None


# ---------------------------------------------------------------- input shapes
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable_shapes(cfg: ModelConfig):
    """long_500k only for sub-quadratic archs (see DESIGN.md §4)."""
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        yield s
