"""Synthetic token pipeline: deterministic and infinite.

The port's counterpart of `repro.training.data`.  Each batch comes from
numpy seeded by (seed, step), exactly as in the reference, so both packages
train on the same tokens and an elastic restart resumes the exact stream.
On a mesh every rank draws the same global batch and keeps its own rows,
as the reference's `batch_sharding` places them, so the losses of a job on
n ranks and on one device compare.
`input_specs` gives a dry run its inputs as meta tensors.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.models import TrainBatch
from repro_torch.models.config import ModelConfig, ShapeSpec


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                    step: int = 0, device="cuda", mesh=None) -> TrainBatch:
    """One deterministic batch on `device`: a Markov-ish token stream (not
    uniform noise, so losses move during short trainings).  Tokens and
    labels are int64.  A VLM's patch embeddings (B, n_patches, d) and an
    audio model's frame embeddings (B, enc_len, d) are `extra`, drawn after
    the tokens from the same generator as in the reference: N(0, 1) * 0.02
    in float64, cast to float32.  With a `mesh`, each leaf is a DTensor
    placed by `sharding.batch_sharding` (rows over the batch axes where
    they divide), each rank keeping its own rows of the same draw."""
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2 ** 63))
    base = rng.integers(0, cfg.vocab, size=(batch, 1), dtype=np.int64)
    drift = rng.integers(-32, 33, size=(batch, seq + 1), dtype=np.int64)
    toks = np.abs(base + np.cumsum(drift, axis=1)) % cfg.vocab
    tokens = torch.from_numpy(np.ascontiguousarray(toks[:, :-1])).to(device)
    labels = torch.from_numpy(np.ascontiguousarray(toks[:, 1:])).to(device)
    tracing.count("host_syncs", 2)   # each a blocking copy from pageable memory
    extra = None
    rows = {"vlm": cfg.n_patches, "audio": cfg.enc_len}.get(cfg.family)
    if rows is not None:
        e = rng.standard_normal((batch, rows, cfg.d_model)) * 0.02
        extra = torch.from_numpy(e.astype(np.float32)).to(device)
        tracing.count("host_syncs")
    out = TrainBatch(tokens=tokens, labels=labels, extra=extra)
    if mesh is None:
        return out
    from repro_torch.sharding import batch_sharding, distribute
    return distribute(out, batch_sharding(out, mesh), mesh)


def stream(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
           start_step: int = 0, device="cuda") -> Iterator[TrainBatch]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, batch, seq, seed=seed, step=step, device=device)
        step += 1


def input_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The inputs of a dry-run cell as meta tensors (shapes and dtypes, no
    allocation), the reference's: int32 tokens, f32 patch or frame
    embeddings.  train: a TrainBatch (a VLM's text is the sequence less its
    patches); prefill: {"tokens", "extra"}; decode: {"tokens"}, one new
    token a sequence against a seq_len cache."""
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    extra, s_text = None, S
    if cfg.family == "vlm":
        s_text = S - cfg.n_patches
        extra = meta(B, cfg.n_patches, cfg.d_model, dtype=torch.float32)
    elif cfg.family == "audio":
        extra = meta(B, cfg.enc_len, cfg.d_model, dtype=torch.float32)
    if shape.kind == "train":
        return TrainBatch(tokens=meta(B, s_text), labels=meta(B, s_text), extra=extra)
    return {"tokens": meta(B, s_text), "extra": extra}
