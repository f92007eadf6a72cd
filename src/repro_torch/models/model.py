"""Model assembly: init / forward / loss / prefill / decode.

The port's counterpart of `repro.models.model`, for all six families:

  dense  : [GQA attention + SwiGLU] blocks with pre-RMSNorm; trained,
           prefilled and decoded.
  moe    : the same blocks with a routed-expert FFN (`models/moe.py`, one
           device) in place of SwiGLU, after `moe.first_dense` dense blocks
           (`pre_layers`); each MoE block adds its load-balance aux loss.
           With `cfg.mla` (deepseek-v2) every block's attention is
           multi-head latent attention (`layers.mla_fwd`) in place of GQA.
  ssm    : xLSTM, groups of one sLSTM block and `slstm_every - 1` mLSTM
           blocks (`models/ssm.py`); trained, prefilled and decoded.
  vlm    : the dense stack behind a `patch_proj` prefix: the patch
           embeddings (`extra`, from the stub frontend) are projected and
           put before the embedded text, positions run over both, and the
           patch rows are dropped before the unembedding.
  hybrid : a Mamba-2 stack with one *shared-weight* GQA+SwiGLU block
           applied every `attn_every` layers (Zamba-style); trained,
           prefilled and decoded.
  audio  : encoder-decoder.  `enc_layers` are dense blocks run non-causally
           over the frame embeddings (`extra`), then `ln_enc`; `layers` are
           decoder blocks: causal self-attention, cross-attention to the
           encoder's memory (k/v projected from it again at every call, no
           RoPE), SwiGLU.

Per-layer params are stacked on axis 0 under the reference's keys (xLSTM:
sLSTM (G, ...) and mLSTM (G, slstm_every - 1, ...) over its G groups), and a
Python loop over layers takes the place of `lax.scan`.  The dense and MoE
cache is {"layers": (k, v)}, each (L, B, S, K, Dh), plus {"pre_layers":
(k, v)} for the first dense blocks (MLA: the latents (c_kv, k_rope), (L,
B, S, kv_lora) and (L, B, S, d_rope)); the hybrid cache is the reference's
{"mamba": MambaState of (L, ...) stacks, "attn": (k, v)}, each
(L // attn_every, B, S, K, Dh), one per application of the shared block;
the xLSTM cache is {"slstm": SLSTMState of (G, ...) stacks, "mlstm":
MLSTMState of (G, slstm_every - 1, ...) stacks}, O(1) in the sequence;
the audio cache is {"self": (k, v), each (L, B, S, K, Dh), of the decoder's
self-attention, "enc": the encoder's memory (B, enc_len, d_model)}.
`decode_step` writes each layer's new row and state into them in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from . import dist
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig, torch_dtype
from .layers import (_init, embed, gqa_fwd, init_embedding, init_gqa, init_mla,
                     init_rmsnorm, init_swiglu, mla_fwd, rmsnorm, swiglu_fwd,
                     unembed)

Params = Dict[str, Any]


def _remat(fn, cfg: ModelConfig):
    """Activation checkpointing: "full" recomputes fn's activations in the
    backward pass (`torch.utils.checkpoint`, non-reentrant, so nested
    checkpoints and params closed over by fn work)."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError("remat='dots' is not ported (no config uses it)")
    return fn


def _layer(stacked: Params, i: int) -> Params:
    """Layer i's params, as views into the (L, ...) stacks (under a mesh,
    gathered over the batch axes where the layer uses them)."""
    return {k: _layer(v, i) if isinstance(v, dict) else dist.unshard_dp(v[i])
            for k, v in stacked.items()}


def _n_layers(stack: Params) -> int:
    """The number of blocks in a dense or MoE block stack."""
    return stack["ln1"]["scale"].shape[0]


# ============================================================== block
@tracing.spanned("models.block", device_time="backward")
def _block_fwd(p: Params, x, cfg: ModelConfig, *, positions, cache=None,
               cache_index=None, causal=True, return_kv=False):
    """One block: GQA attention (MLA with cfg.mla), then SwiGLU or, in a
    block with "moe" params, the routed experts.  Returns (x, cache or
    None, aux): aux is the MoE block's f32 load-balance loss, 0.0 for a
    dense block."""
    x = dist.constrain_batch(x)
    attn_fn = mla_fwd if cfg.mla else gqa_fwd
    h, new_cache = attn_fn(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                           positions=positions, cache=cache,
                           cache_index=cache_index, causal=causal,
                           return_kv=return_kv)
    # under a mesh the residual is pinned before the norm: a sum that is
    # partial over `model` would otherwise be reduce-scattered along the
    # sequence
    x = dist.constrain_batch(x + h)
    hn = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        h, aux = moe_mod.moe_fwd(p["moe"], hn, cfg)
    else:
        h, aux = swiglu_fwd(p["ffn"], hn, cfg.compute_dtype), 0.0
    return dist.constrain_batch(x + h), new_cache, aux


# ================================================================== init
def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random params from a seeded `torch.Generator` on `device`, with the
    reference's keys and shapes.  The numbers differ from `jax.random`'s;
    tests carry JAX params over with `convert.from_jax_params`.  An unknown
    family raises the reference's `ValueError`."""
    device = torch.device(device)
    gen = None  # the meta device has no generator: shapes only
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    p = {"embed": init_embedding(gen, cfg), "ln_f": init_rmsnorm(d, dt, device)}
    if cfg.family == "hybrid":
        p["layers"] = ssm_mod.init_mamba2(gen, cfg, lead=(cfg.n_layers,))
        p["shared_attn"] = _init_block(gen, cfg, device)
    elif cfg.family == "ssm":
        G, n_m = _xlstm_groups(cfg)
        p["slstm"] = ssm_mod.init_slstm(gen, cfg, lead=(G,))
        p["mlstm"] = ssm_mod.init_mlstm(gen, cfg, lead=(G, n_m))
    elif cfg.family == "audio":
        p["enc_layers"] = _init_block(gen, cfg, device, lead=(cfg.n_enc_layers,))
        p["layers"] = _init_dec_block(gen, cfg, device, lead=(cfg.n_layers,))
        p["ln_enc"] = init_rmsnorm(d, dt, device)
    elif cfg.family in ("dense", "moe", "vlm"):
        n_pre = _n_pre(cfg)
        if n_pre:
            p["pre_layers"] = _init_block(gen, cfg, device, lead=(n_pre,))
        p["layers"] = _init_block(gen, cfg, device, lead=(cfg.n_layers - n_pre,),
                                  moe_layer=cfg.moe is not None)
    else:
        raise ValueError(cfg.family)
    if cfg.family == "vlm" and cfg.n_patches:
        p["patch_proj"] = _init(gen, (d, d), d ** -0.5, dt)
    return p


def _xlstm_groups(cfg: ModelConfig):
    """(G, n_m): an xLSTM's groups, each one sLSTM block then n_m mLSTM
    blocks."""
    every = cfg.xlstm.slstm_every
    assert cfg.n_layers % every == 0, "xlstm group structure"
    return cfg.n_layers // every, every - 1


def _n_pre(cfg: ModelConfig) -> int:
    """The dense blocks an MoE model runs first (`pre_layers`)."""
    return cfg.moe.first_dense if cfg.moe else 0


def _init_block(gen, cfg: ModelConfig, device, lead=(), moe_layer=False) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    p = {
        "ln1": init_rmsnorm(d, dt, device, lead=lead),
        "ln2": init_rmsnorm(d, dt, device, lead=lead),
        "attn": init_mla(gen, cfg, lead=lead) if cfg.mla else init_gqa(gen, cfg, lead=lead),
    }
    if moe_layer:
        p["moe"] = moe_mod.init_moe(gen, cfg, lead=lead)
    else:
        d_ff = cfg.moe.d_first_dense if _n_pre(cfg) else cfg.d_ff
        p["ffn"] = init_swiglu(gen, d, d_ff, dt, lead=lead)
    return p


def _init_dec_block(gen, cfg: ModelConfig, device, lead=()) -> Params:
    """An audio decoder block: self-attention, cross-attention, SwiGLU, each
    behind its RMSNorm."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d, dt, device, lead=lead),
        "ln_x": init_rmsnorm(d, dt, device, lead=lead),
        "ln2": init_rmsnorm(d, dt, device, lead=lead),
        "attn": init_gqa(gen, cfg, lead=lead),
        "xattn": init_gqa(gen, cfg, lead=lead),
        "ffn": init_swiglu(gen, d, cfg.d_ff, dt, lead=lead),
    }


def _dec_block_fwd(p: Params, x, enc, cfg: ModelConfig, *, positions, cache=None,
                   cache_index=None, return_kv=False):
    """One decoder block: causal self-attention (against `cache` in decode;
    with return_kv its new (k, v) come back), cross-attention over the
    encoder's memory `enc`, SwiGLU.  Returns (x, self-attention cache or
    None)."""
    x = dist.constrain_batch(x)
    h, new_self = gqa_fwd(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                          positions=positions, cache=cache, cache_index=cache_index,
                          causal=True, return_kv=return_kv)
    x = dist.constrain_batch(x + h)
    h, _ = gqa_fwd(p["xattn"], rmsnorm(p["ln_x"], x, cfg.norm_eps), cfg,
                   positions=positions, kv_source=enc)
    x = dist.constrain_batch(x + h)
    h = swiglu_fwd(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.compute_dtype)
    return x + h, new_self


def _patches(params: Params, extra, cfg: ModelConfig):
    """A VLM's patch embeddings (B, P, d) projected by `patch_proj`, in the
    compute dtype: the rows put before the embedded text."""
    ct = torch_dtype(cfg.compute_dtype)
    return torch.einsum("bpd,de->bpe", extra.to(ct),
                        dist.unshard_dp(params["patch_proj"]).to(ct))


def _encode(params: Params, extra, cfg: ModelConfig, remat: bool = True):
    """The audio encoder: the frame embeddings (B, enc_len, d) through the
    non-causal `enc_layers` at positions 0..enc_len-1 (each block
    checkpointed as cfg.remat says, when `remat`), then `ln_enc`."""
    enc = extra.to(torch_dtype(cfg.compute_dtype))
    e_pos = _positions(enc.shape[0], 0, enc.shape[1], enc.device)
    stack = params["enc_layers"]

    def body(h, i):
        return _block_fwd(_layer(stack, i), h, cfg, positions=e_pos, causal=False)[0]

    if remat:
        body = _remat(body, cfg)
    for i in range(_n_layers(stack)):
        enc = body(enc, i)
    return rmsnorm(params["ln_enc"], enc, cfg.norm_eps)


def _stacks(params: Params):
    """The dense and MoE block stacks in the order they run: `pre_layers`
    (when the model has them), then `layers`."""
    return [name for name in ("pre_layers", "layers") if name in params]


def _positions(B: int, start: int, S: int, device) -> torch.Tensor:
    return torch.arange(start, start + S, device=device)[None].expand(B, S)


# ---------------------------------------------------------------- hybrid util
def _hybrid_split(cfg: ModelConfig, stacked):
    """(L, ...) stacked mamba params -> ((G, k, ...), (tail, ...)), views."""
    k = cfg.attn_every
    g = cfg.n_layers // k
    body = {n: v[:g * k].reshape(g, k, *v.shape[1:]) for n, v in stacked.items()}
    tail = {n: v[g * k:] for n, v in stacked.items()}
    return body, tail


def _hybrid_join(cfg: ModelConfig, body, tail):
    """The inverse of `_hybrid_split`."""
    return {n: torch.cat([b.reshape(-1, *b.shape[2:]), tail[n]], dim=0)
            for n, b in body.items()}


# ============================================================ forward (train)
class TrainBatch(NamedTuple):
    tokens: torch.Tensor                   # (B, S) inputs
    labels: torch.Tensor                   # (B, S) next-token targets
    extra: Optional[torch.Tensor] = None   # vlm patches / audio frames (B, P, d)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, padded_vocab); `extra` is a VLM's
    patch embeddings (optional) or an audio model's frame embeddings.
    Layers (dense, MoE, VLM, both audio stacks), groups and their mLSTM
    blocks (xLSTM) or groups and tail layers (hybrid) are checkpointed as
    cfg.remat says."""
    return _forward(params, tokens, cfg, extra)[0]


def _forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
             extra: Optional[torch.Tensor] = None):
    """`forward`, with the aux loss summed over the MoE blocks: (logits,
    aux f32 scalar, 0 for the other families)."""
    x = embed(params["embed"], tokens, cfg)
    n_patch = 0
    if cfg.family == "vlm" and extra is not None:
        x = dist.constrain_batch(torch.cat([_patches(params, extra, cfg), x], dim=1))
        n_patch = extra.shape[1]
    positions = _positions(x.shape[0], 0, x.shape[1], tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.family == "hybrid":
        x = _hybrid_forward(params, x, positions, cfg)
    elif cfg.family == "ssm":
        x = _xlstm_forward(params, x, cfg)
    elif cfg.family == "audio":
        enc = _encode(params, extra, cfg)
        stack = params["layers"]

        def dec_body(h, i, enc):
            return _dec_block_fwd(_layer(stack, i), h, enc, cfg, positions=positions)[0]

        dec_body = _remat(dec_body, cfg)
        for i in range(_n_layers(stack)):
            x = dec_body(x, i, enc)
    else:
        for name in _stacks(params):
            def body(h, i, stack=params[name]):
                h, _, a = _block_fwd(_layer(stack, i), h, cfg, positions=positions)
                return h, a
            body = _remat(body, cfg)
            for i in range(_n_layers(params[name])):
                x, a = body(x, i)
                aux = aux + a
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed(params["embed"], x[:, n_patch:], cfg), aux


def _hybrid_forward(params: Params, x, positions, cfg: ModelConfig):
    """Groups of `attn_every` Mamba-2 layers, each group followed by the
    shared block (the same params at every application), then the tail
    layers.  As in the reference, each group is checkpointed and so is
    each Mamba-2 layer inside it."""
    shared = params["shared_attn"]
    body, tail = _hybrid_split(cfg, params["layers"])

    def m_body(h, lp):
        h = dist.constrain_batch(h)
        d, _ = ssm_mod.mamba2_fwd(lp, h, cfg)
        return dist.constrain_batch(h + d)

    m_body = _remat(m_body, cfg)

    def group_body(h, gi):
        gp = _layer(body, gi)
        for j in range(cfg.attn_every):
            h = m_body(h, _layer(gp, j))
        return _block_fwd(shared, h, cfg, positions=positions)[0]

    group_body = _remat(group_body, cfg)
    for gi in range(cfg.n_layers // cfg.attn_every):
        x = group_body(x, gi)
    for j in range(cfg.n_layers % cfg.attn_every):
        x = m_body(x, _layer(tail, j))
    return x


def _xlstm_forward(params: Params, x, cfg: ModelConfig):
    """Each group: the sLSTM block, then its mLSTM blocks, each block
    residual.  As in the reference, each group is checkpointed and so is
    each mLSTM block inside it."""
    G, n_m = _xlstm_groups(cfg)

    def m_body(h, lp):
        h = dist.constrain_batch(h)
        return dist.constrain_batch(h + ssm_mod.mlstm_fwd(lp, h, cfg)[0])

    m_body = _remat(m_body, cfg)

    def group_body(h, gi):
        h = dist.constrain_batch(h)
        h = dist.constrain_batch(h + ssm_mod.slstm_fwd(_layer(params["slstm"], gi), h, cfg)[0])
        mp = _layer(params["mlstm"], gi)
        for j in range(n_m):
            h = m_body(h, _layer(mp, j))
        return h

    group_body = _remat(group_body, cfg)
    for gi in range(G):
        x = group_body(x, gi)
    return x


def loss_fn(params: Params, batch: TrainBatch, cfg: ModelConfig,
            aux_coef: float = 0.01):
    """Next-token cross-entropy over the padded vocab, plus a 1e-4 z-loss
    and `aux_coef` times the MoE blocks' summed aux loss (0 for the other
    families).  Returns (loss, {"nll", "aux", "zloss"}), all f32 scalars."""
    logits, aux = _forward(params, batch.tokens, cfg, batch.extra)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit by gather: the same value as the reference's masked
    # sum (one non-zero term), without a (B, S, V) mask; kept (B, S, 1) and
    # (under a mesh) reduced at once, as DTensor's gather on vocab-sharded
    # logits leaves a partial sum masked to its result's shape
    gold = dist.constrain_batch(torch.gather(logits, -1, batch.labels[..., None].long()))
    nll = (logz[..., None] - gold).mean()
    zloss = 1e-4 * (logz ** 2).mean()
    loss = nll + zloss + aux_coef * aux
    return loss, {"nll": nll, "aux": aux, "zloss": zloss}


# ======================================================== caches + decode step
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda"):
    """Zero-filled cache: dense and MoE {"layers": (k, v)}, each (L, B,
    max_seq, K, Dh) (MLA: (c_kv, k_rope), (L, B, max_seq, kv_lora) and (L,
    B, max_seq, d_rope)), and {"pre_layers": (k, v)} of the first dense
    blocks when the model has them; hybrid {"mamba": MambaState stacked over the
    L layers, "attn": (k, v)}, each (L // attn_every, B, max_seq, K, Dh);
    xLSTM {"slstm": SLSTMState stacked over the G groups, "mlstm":
    MLSTMState stacked (G, slstm_every - 1)}, zero but the stabilizers
    (-1e30), whatever max_seq; audio {"self": (k, v), each (L, B, max_seq,
    K, Dh), "enc": (B, enc_len, d_model)}.  An unknown family raises the
    reference's `ValueError`."""
    ct = torch_dtype(cfg.compute_dtype)

    def kv(n):
        if cfg.mla:
            shapes = [(n, batch, max_seq, cfg.mla.kv_lora), (n, batch, max_seq, cfg.mla.d_rope)]
        else:
            shapes = [(n, batch, max_seq, cfg.n_kv, cfg.d_head)] * 2
        return tuple(torch.zeros(s, dtype=ct, device=device) for s in shapes)

    if cfg.family == "hybrid":
        st = ssm_mod.init_mamba_state(cfg, batch, device)
        mamba = ssm_mod.MambaState(*(t.new_zeros((cfg.n_layers, *t.shape)) for t in st))
        return {"mamba": mamba, "attn": kv(cfg.n_layers // cfg.attn_every)}
    if cfg.family == "ssm":
        G, n_m = _xlstm_groups(cfg)
        s_st = ssm_mod.init_slstm_state(cfg, batch, device)
        m_st = ssm_mod.init_mlstm_state(cfg, batch, device)
        return {"slstm": ssm_mod.SLSTMState(*(t.expand(G, *t.shape).clone() for t in s_st)),
                "mlstm": ssm_mod.MLSTMState(*(t.expand(G, n_m, *t.shape).clone()
                                              for t in m_st))}
    if cfg.family == "audio":
        return {"self": kv(cfg.n_layers),
                "enc": torch.zeros((batch, cfg.enc_len, cfg.d_model), dtype=ct,
                                   device=device)}
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(cfg.family)
    n_pre = _n_pre(cfg)
    out = {"layers": kv(cfg.n_layers - n_pre)}
    if n_pre:
        out["pre_layers"] = kv(n_pre)
    return out


def decode_step(params: Params, cache, tokens: torch.Tensor, pos: int,
                cfg: ModelConfig):
    """One token for every sequence.  tokens: (B, 1); pos: the cache index
    it is written at (unused by xLSTM).  Updates cache in place; returns
    (logits (B, V), cache).  An audio model's decoder attends to
    cache["enc"], which the step leaves as it is."""
    x = embed(params["embed"], tokens, cfg)
    positions = _positions(x.shape[0], pos, 1, x.device)
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, cache, x, positions, pos, cfg)
    elif cfg.family == "ssm":
        x = _xlstm_decode(params, cache, x, cfg)
    elif cfg.family == "audio":
        ck, cv = cache["self"]
        for i in range(_n_layers(params["layers"])):
            x, _ = _dec_block_fwd(_layer(params["layers"], i), x, cache["enc"], cfg,
                                  positions=positions, cache=(ck[i], cv[i]),
                                  cache_index=pos)
    else:
        for name in _stacks(params):
            ck, cv = cache[name]
            for i in range(_n_layers(params[name])):
                x, _, _ = _block_fwd(_layer(params[name], i), x, cfg, positions=positions,
                                     cache=(ck[i], cv[i]), cache_index=pos)
    x = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0], cfg)[..., :cfg.vocab]
    return logits, cache


def _hybrid_decode(params: Params, cache, x, positions, pos: int, cfg: ModelConfig):
    """The reference's `_hybrid_decode`: each layer's Mamba-2 recurrence
    from its state in cache["mamba"] (written back in place), the shared
    block after every `attn_every` layers against its own attention cache,
    then the tail layers."""
    mamba = cache["mamba"]
    ck, cv = cache["attn"]
    for i in range(cfg.n_layers):
        d, st = ssm_mod.mamba2_fwd(_layer(params["layers"], i), x, cfg,
                                   state=ssm_mod.MambaState(*(t[i] for t in mamba)))
        x = x + d
        for full, new in zip(mamba, st):
            full[i].copy_(new)
        if _shared_block_after(cfg, i):
            g = i // cfg.attn_every
            x, _, _ = _block_fwd(params["shared_attn"], x, cfg, positions=positions,
                                 cache=(ck[g], cv[g]), cache_index=pos)
    return x


def _xlstm_decode(params: Params, cache, x, cfg: ModelConfig):
    """The reference's xLSTM decode: each block's one-token recurrence from
    its state in cache["slstm"] / cache["mlstm"], written back in place."""
    G, n_m = _xlstm_groups(cfg)
    s_cache, m_cache = cache["slstm"], cache["mlstm"]
    for gi in range(G):
        d, st = ssm_mod.slstm_fwd(_layer(params["slstm"], gi), x, cfg,
                                  state=ssm_mod.SLSTMState(*(t[gi] for t in s_cache)))
        x = x + d
        for full, new in zip(s_cache, st):
            full[gi].copy_(new)
        mp = _layer(params["mlstm"], gi)
        for j in range(n_m):
            d, st = ssm_mod.mlstm_fwd(_layer(mp, j), x, cfg,
                                      state=ssm_mod.MLSTMState(*(t[gi, j] for t in m_cache)))
            x = x + d
            for full, new in zip(m_cache, st):
                full[gi, j].copy_(new)
    return x


def _shared_block_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the shared block follows Mamba-2 layer i: it closes each full
    group of `attn_every` layers; the tail layers have none."""
    k = cfg.attn_every
    return (i + 1) % k == 0 and i + 1 <= cfg.n_layers // k * k


# ---------------------------------------------------------------- prefill
def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            extra: Optional[torch.Tensor] = None):
    """Process a full prompt; returns (last-token logits (B, V), cache), the
    cache as `init_cache` lays it out, S rows long.  A VLM given its patch
    embeddings `extra` (B, P, d) puts them before the text, and its cache
    is P + S rows long; without them it runs the text alone (as the
    reference's engine drives it).  An audio model takes its frame
    embeddings as `extra` and keeps the encoder's memory as cache["enc"].
    A hybrid (xLSTM) prompt longer than one SSD (mLSTM) chunk must be a
    multiple of it, as in the reference."""
    x = embed(params["embed"], tokens, cfg)
    if cfg.family == "vlm" and extra is not None:
        x = dist.constrain_batch(torch.cat([_patches(params, extra, cfg), x], dim=1))
    positions = _positions(x.shape[0], 0, x.shape[1], tokens.device)
    if cfg.family == "hybrid":
        x, cache = _hybrid_prefill(params, x, positions, cfg)
    elif cfg.family == "ssm":
        x, cache = _xlstm_prefill(params, x, cfg)
    elif cfg.family == "audio":
        enc = _encode(params, extra, cfg, remat=False)
        ks, vs = [], []
        for i in range(_n_layers(params["layers"])):
            x, (k, v) = _dec_block_fwd(_layer(params["layers"], i), x, enc, cfg,
                                       positions=positions, return_kv=True)
            ks.append(k)
            vs.append(v)
        cache = {"self": (torch.stack(ks), torch.stack(vs)), "enc": enc}
    else:
        cache = {}
        for name in _stacks(params):
            ks, vs = [], []
            for i in range(_n_layers(params[name])):
                x, (k, v), _ = _block_fwd(_layer(params[name], i), x, cfg,
                                          positions=positions, return_kv=True)
                ks.append(k)
                vs.append(v)
            cache[name] = (torch.stack(ks), torch.stack(vs))
    x = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params["embed"], x[:, 0], cfg)[..., :cfg.vocab]
    return logits, cache


def _hybrid_prefill(params: Params, x, positions, cfg: ModelConfig):
    """The reference's hybrid prefill: every Mamba-2 layer runs the chunked
    scan and keeps its final state, the shared block after every
    `attn_every` layers keeps its k/v; the tail layers last."""
    states, ks, vs = [], [], []
    for i in range(cfg.n_layers):
        d, st = ssm_mod.mamba2_fwd(_layer(params["layers"], i), x, cfg, return_state=True)
        x = x + d
        states.append(st)
        if _shared_block_after(cfg, i):
            x, (kk, vv), _ = _block_fwd(params["shared_attn"], x, cfg,
                                        positions=positions, return_kv=True)
            ks.append(kk)
            vs.append(vv)
    mamba = ssm_mod.MambaState(*(torch.stack(t) for t in zip(*states)))
    return x, {"mamba": mamba, "attn": (torch.stack(ks), torch.stack(vs))}


def _xlstm_prefill(params: Params, x, cfg: ModelConfig):
    """The reference's xLSTM prefill: every block runs over the prompt and
    keeps its state after the last token (the mLSTM through the chunked
    scan's final state)."""
    G, n_m = _xlstm_groups(cfg)

    def stack(states, cls):
        return cls(*(torch.stack(t) for t in zip(*states)))

    s_states, m_states = [], []
    for gi in range(G):
        d, st = ssm_mod.slstm_fwd(_layer(params["slstm"], gi), x, cfg, return_state=True)
        x = x + d
        s_states.append(st)
        mp, group = _layer(params["mlstm"], gi), []
        for j in range(n_m):
            d, st = ssm_mod.mlstm_fwd(_layer(mp, j), x, cfg, return_state=True)
            x = x + d
            group.append(st)
        m_states.append(stack(group, ssm_mod.MLSTMState))
    return x, {"slstm": stack(s_states, ssm_mod.SLSTMState),
               "mlstm": stack(m_states, ssm_mod.MLSTMState)}
