"""Batched serving engine for on-demand jobs (PyTorch port).

Counterpart of `repro.serving.engine`: requests are grouped into one
left-padded batch, prefilled once, then decoded greedily step by step;
finished sequences stop collecting tokens.  This is the execution payload
of the paper's *on-demand* job class.

The cache follows the reference's `_grow`, leaf by leaf (`layers` and, in
an MoE model with dense first blocks, `pre_layers`): a leaf is `max_seq`
long when the prompt length S is the largest axis of its (L, B, S, K, Dh)
prefill cache, and stays S long otherwise.  Then every decode step writes
its k/v into the last row (`models.layers.gqa_fwd`, as JAX's
`dynamic_update_slice` clamps), so short prompts give the reference's
tokens too.  An MLA model's latents (L, B, S, kv_lora) and (L, B, S,
d_rope) follow the same rule: under kv_lora prompt tokens only k_rope
grows, and the first decode step raises on score tensors of S and max_seq
columns, as the reference's does (a batch must be padded to at least
kv_lora tokens).  The same rule leaves a GQA leaf (L, B, S, K, Dh)
prompt-long when S is under L, B, K or Dh (internvl2-1b: 24 layers, d_head
64), and every decode step then overwrites the last prompt row, in both
packages: pad such a batch to at least that many tokens.

As in the reference, pads are token 0 and prefill and decode attend to them
(the prompt is not masked), so the port's tokens equal the reference's.  A
VLM serves text alone: the reference's engine passes no patches.
Recurrent, hybrid and encoder-decoder models are refused, as the reference
refuses them: they serve through `models.prefill` and `models.decode_step`
directly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


@dataclass
class Request:
    """One inference request.

    ``submitted_at`` / ``first_token_at`` / ``done_at`` are monotonic
    timestamps (``time.monotonic``): they exist to be subtracted — TTFT,
    decode time, SLO accounting — and must not jump with wall-clock
    adjustments.  ``submitted_wall`` is the one wall-clock stamp, kept
    for human-readable logs; never diff it against the monotonic fields.
    """

    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    submitted_at: float = field(default_factory=time.monotonic)
    submitted_wall: float = field(default_factory=time.time)
    tokens_out: List[int] = field(default_factory=list)
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


class ServeEngine:
    """Greedy batched decoding on `device`, for at most max_seq positions.
    params must already live on that device.  `step_seconds` holds the
    last batch's decode steps, each from its launch to its tokens on the
    host (`time.monotonic`)."""

    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 512,
                 eos_id: Optional[int] = None, device="cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):  # the reference's refusal
            raise NotImplementedError(
                "ServeEngine drives attention-family LMs; recurrent archs "
                "serve via decode_step directly")
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = torch.device(device)
        self.step_seconds: List[float] = []

    def serve_batch(self, requests: List[Request]) -> List[Request]:
        """Run a padded batch of requests to completion."""
        B = len(requests)
        lens = [len(r.prompt) for r in requests]
        S = max(lens)
        if S > self.max_seq:
            raise ValueError(f"prompt of {S} tokens exceeds max_seq={self.max_seq}")
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(requests):
            toks[i, S - lens[i]:] = r.prompt    # left-pad to align last token
        logits, cache = prefill(self.params, torch.from_numpy(toks).to(self.device),
                                self.cfg)
        cache = {name: tuple(_grow(c, self.max_seq) for c in kv)
                 for name, kv in cache.items()}
        next_tok = logits.argmax(dim=-1)
        first = next_tok.tolist()
        live = np.ones((B,), bool)
        n_steps = max(r.max_new_tokens for r in requests)
        now = time.monotonic()
        for i, r in enumerate(requests):
            r.first_token_at = now
            r.tokens_out.append(first[i])
        self.step_seconds = []
        for step in range(1, n_steps):
            pos = S + step - 1
            if pos >= self.max_seq:
                break
            t0 = time.monotonic()
            logits, cache = decode_step(self.params, cache, next_tok[:, None],
                                        pos, self.cfg)
            next_tok = logits.argmax(dim=-1)
            toks_host = next_tok.tolist()
            self.step_seconds.append(time.monotonic() - t0)
            for i, r in enumerate(requests):
                if not live[i]:
                    continue
                r.tokens_out.append(toks_host[i])
                if len(r.tokens_out) >= r.max_new_tokens or \
                        (self.eos_id is not None and toks_host[i] == self.eos_id):
                    live[i] = False
                    r.done_at = time.monotonic()
            if not live.any():
                break
        now = time.monotonic()
        for r in requests:
            r.done_at = r.done_at or now
        return requests


def _grow(c: torch.Tensor, max_seq: int) -> torch.Tensor:
    """The reference's `_grow`: zero-pad a prefill cache leaf to max_seq on
    its seq axis, the first of axes -3 and -2 that is shorter than max_seq
    and the leaf's largest axis; other leaves come back as they are."""
    for ax in (-3, -2):
        if c.ndim >= 3 and 0 < c.shape[ax] < max_seq and c.shape[ax] == max(c.shape):
            return F.pad(c, [0, 0] * (-ax - 1) + [0, max_seq - c.shape[ax]])
    return c
