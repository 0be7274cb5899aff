"""Language-model assembly for every family (counterpart of
`repro.models.lm`):
  dense/vlm/audio/encoder - uniform [attention + FFN] blocks,
  moe    - leading dense blocks + MoE blocks (deepseek-v3, arctic),
  ssm    - Mamba2 (SSD) blocks,
  hybrid - Mamba2 groups of `hybrid_period` blocks, each followed by a
           weight-shared attention block fed by the concat of the hidden
           state and the original embedding (zamba2).

Entry points, as in the reference (params is an `LM` module):
  init_params(cfg, generator, device) -> LM (f32 masters)
  forward(params, cfg, batch, remat=.., with_aux=..)
                                      -> logits, or (logits, aux) [train]
  loss_fn(params, cfg, batch, remat=..) -> (loss, {"loss", "aux"})
  make_trainable(params)              -> params, every one requiring grad
  prefill(params, cfg, batch)         -> (logits, cache)
  decode_step(params, cfg, tokens, cache) -> (logits, cache) [one token]
  make_cache(cfg, B, S, device)       -> zeroed cache dict
  param_counts(cfg)                   -> (total, active per token)

`batch` holds tensors on the model's device: "tokens" [B, S] integers,
plus "patches" [B, n_patches, d_model] for a VLM (a prefix in front of
the tokens, so the cache counts n_patches + S positions), or "frames"
[B, S, frame_dim] for audio. The cache keeps the reference's layout:
k/v [L,B,S,KV,dh] (MLA: latent [L,B,S,kv_lora] as "k" and rope keys
[L,B,S,qk_rope] as "v"); ssm [L,B,H,P,N] (f32) / conv [L,B,CONV_K-1,
conv_dim]; hybrid ssm/conv with [G, period] leading axes and the shared
block's k/v [G,B,S,KV,dh]; activations in COMPUTE_DTYPE; plus "len"
(0-dim int32, the positions it holds). An encoder's prefill returns only
"len". `decode_step` updates the cache tensors in place and returns the
same dict with "len" advanced.

Devices: `init_params` and `make_cache` run on CUDA unless given
another device (`device="cpu"`, or "meta" for shapes only).

Activations carry the reference's logical sharding constraints
(`parallel.constrain.constrain`: the embedding, each block's output, the
logits); they return their input unless a launcher maps the logical
axes to a mesh and the tensors are DTensors.

Training: parameters are built frozen (`requires_grad=False`), so
serving never records a graph; `make_trainable` switches them on, and
only the train path calls it. Gradients reach the attention and SSD
kernels through their autograd Functions (`repro_torch.kernels`).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core.engine import resolve_device
from repro_torch.models import layers, mla, moe, ssm
from repro_torch.models.layers import ParamTree
from repro_torch.parallel import spmd
from repro_torch.parallel.constrain import constrain

COMPUTE_DTYPE = torch.bfloat16
MTP_WEIGHT = 0.3
ATTN_FAMILIES = ("dense", "vlm", "audio", "encoder")


def _module(node):
    """A params node as a module: a dict as a `ParamTree`, a list as an
    `nn.ModuleList` (hybrid blocks nest two), a tensor as a parameter."""
    if isinstance(node, dict):
        return ParamTree(node)
    if isinstance(node, list):
        return nn.ModuleList(_module(n) for n in node)
    return nn.Parameter(node, requires_grad=False)


class LM(nn.Module):
    """The model's parameters under the reference's group and leaf names:
    `embed` (tok, ln_f, head, frame_proj), one `ParamTree` per layer in
    `blocks` (hybrid: a list per group), `dense_blocks` / `moe_blocks`,
    `shared`, `shared_in`, `mtp_proj`, `mtp_block`. The reference stacks
    the layers on leading axes instead."""

    def __init__(self, cfg, groups: dict):
        super().__init__()
        self.cfg = cfg
        for name, node in groups.items():
            setattr(self, name, _module(node))

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, self.cfg, batch)


def make_trainable(params: LM) -> LM:
    """Switches every parameter of `params` to require grad (in place;
    the train path's, never serving's). Returns params."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


# ------------------------------------------------------------------ blocks
def init_dense_block(cfg, generator, device, use_moe: bool = False) -> dict:
    p = {"ln1": layers.init_norm(cfg.d_model, cfg.norm, device),
         "ln2": layers.init_norm(cfg.d_model, cfg.norm, device)}
    if cfg.attn_kind == "mla":
        p["attn"] = mla.init_mla(cfg, generator, device)
    else:
        p["attn"] = layers.init_attention(cfg, generator, device)
    if use_moe:
        p["ffn"] = moe.init_moe(cfg, generator, device)
    else:
        p["ffn"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp, generator,
                                   device,
                                   bias=(cfg.mlp == "gelu" and cfg.qkv_bias))
    return p


def dense_block_apply(p, h, cfg, use_moe: bool = False):
    """Full-sequence block. Returns (h, MoE aux loss (0.0 without MoE),
    kv) where kv is the (k, v) / MLA (c_kv, k_rope) pair for the
    cache."""
    hn = layers.apply_norm(h, p["ln1"], cfg.norm)
    if cfg.attn_kind == "mla":
        a, kv = mla.mla_apply(p["attn"], hn, cfg)
    else:
        a, kv = layers.attention_apply(p["attn"], hn, cfg)
    h = h + a
    hn = layers.apply_norm(h, p["ln2"], cfg.norm)
    if use_moe:
        f, aux = moe.moe_apply(p["ffn"], hn, cfg)
    else:
        f, aux = layers.mlp_apply(p["ffn"], hn, cfg.mlp), 0.0
    return constrain(h + f, "dp", None, None), aux, kv


def dense_block_decode(p, h, cfg, ck, cv, length, use_moe: bool = False):
    hn = layers.apply_norm(h, p["ln1"], cfg.norm)
    if cfg.attn_kind == "mla":
        a, (ck, cv) = mla.mla_decode(p["attn"], hn, cfg, ck, cv, length)
    else:
        a, (ck, cv) = layers.attention_decode(p["attn"], hn, cfg, ck, cv,
                                              length)
    h = h + a
    hn = layers.apply_norm(h, p["ln2"], cfg.norm)
    if use_moe:
        f, _ = moe.moe_apply(p["ffn"], hn, cfg)
    else:
        f = layers.mlp_apply(p["ffn"], hn, cfg.mlp)
    return h + f, ck, cv


def init_mamba_block(cfg, generator, device) -> dict:
    return {"ln": layers.init_norm(cfg.d_model, cfg.norm, device),
            "mixer": ssm.init_mamba2(cfg, generator, device)}


def mamba_block_apply(p, h, cfg):
    """Full-sequence block. Returns (h, final ssm state, conv tail)."""
    hn = layers.apply_norm(h, p["ln"], cfg.norm)
    y, s_final = ssm.mamba2_apply(p["mixer"], hn, cfg)
    # conv tail for decode handoff: last CONV_K-1 pre-conv features.
    proj = layers.dense(hn, p["mixer"]["in_proj"])
    _, xBC, _ = ssm._split_in(proj, cfg)
    conv_tail = xBC[:, -(ssm.CONV_K - 1):, :]
    return constrain(h + y, "dp", None, None), s_final, conv_tail


def mamba_block_train(p, h, cfg):
    """The block's output alone (the train path: no cache to hand
    over)."""
    return constrain(h + ssm.mamba2_apply(p["mixer"], layers.apply_norm(
        h, p["ln"], cfg.norm), cfg)[0], "dp", None, None)


def mamba_block_decode(p, h, cfg, s, conv):
    hn = layers.apply_norm(h, p["ln"], cfg.norm)
    y, s_new, conv_new = ssm.mamba2_decode(p["mixer"], hn, cfg, s, conv)
    return h + y, s_new, conv_new


def _shared_in(params, h, h0):
    """The hybrid shared block's input: [h, h0] @ shared_in."""
    return layers.dense(torch.cat([h, h0], dim=-1), params.shared_in)


# --------------------------------------------------------------- embedding
def init_embed(cfg, generator, device) -> dict:
    p = {"tok": layers.normal((cfg.vocab, cfg.d_model), 0.02, generator,
                              device),
         "ln_f": layers.init_norm(cfg.d_model, cfg.norm, device)}
    if not cfg.tie_embeddings:
        p["head"] = layers.normal((cfg.d_model, cfg.vocab),
                                  1.0 / np.sqrt(cfg.d_model), generator,
                                  device)
    if cfg.frame_dim:
        p["frame_proj"] = layers.normal((cfg.frame_dim, cfg.d_model),
                                        1.0 / np.sqrt(cfg.frame_dim),
                                        generator, device)
    return p


def _tokens(params, tokens):
    """Token embedding in COMPUTE_DTYPE (gathered, then cast: the same
    values as the reference's cast-then-gather)."""
    tok = params.embed["tok"]
    if spmd.is_dtensor(tok):                     # vocabulary-parallel
        return spmd.embedding(tok, tokens).to(COMPUTE_DTYPE)
    return tok[tokens.long()].to(COMPUTE_DTYPE)


def embed_inputs(params, cfg, batch):
    """Token / modality-stub embedding [B, S', d_model]: audio frames
    through frame_proj; a VLM's patches in front of its tokens."""
    p = params.embed
    if cfg.frame_dim:                                   # audio stub
        return layers.dense(batch["frames"].to(COMPUTE_DTYPE),
                            p["frame_proj"])
    tok = _tokens(params, batch["tokens"])
    if cfg.n_patches:                                   # vlm stub
        return torch.cat([batch["patches"].to(COMPUTE_DTYPE), tok], dim=1)
    return tok


def lm_head(params, cfg, h):
    p = params.embed
    h = layers.apply_norm(h, p["ln_f"], cfg.norm)
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return constrain(layers.dense(h, w), "dp", None, "tp")


# ------------------------------------------------------------- init params
def init_params(cfg, generator=None, device=None) -> LM:
    """Random f32 master weights drawn from `generator` (a
    `torch.Generator` on `device`; unused on the meta device). The
    distributions are the reference's; the numbers are torch's."""
    device = resolve_device(device)
    if device.type != "meta" and generator is None:
        raise ValueError("init_params needs a torch.Generator on "
                         f"{device} (only the meta device draws nothing)")
    g, dev = generator, device

    def dense(n, use_moe=False):
        return [init_dense_block(cfg, g, dev, use_moe) for _ in range(n)]

    groups: Dict[str, Any] = {"embed": init_embed(cfg, g, dev)}
    if cfg.family in ATTN_FAMILIES:
        groups["blocks"] = dense(cfg.n_layers)
    elif cfg.family == "moe":
        if cfg.n_dense_layers:
            groups["dense_blocks"] = dense(cfg.n_dense_layers)
        groups["moe_blocks"] = dense(cfg.n_layers - cfg.n_dense_layers, True)
    elif cfg.family == "ssm":
        groups["blocks"] = [init_mamba_block(cfg, g, dev)
                            for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        groups["blocks"] = [[init_mamba_block(cfg, g, dev)
                             for _ in range(cfg.hybrid_period)]
                            for _ in range(cfg.n_layers // cfg.hybrid_period)]
        groups["shared"] = init_dense_block(cfg, g, dev)
        groups["shared_in"] = layers.normal(
            (2 * cfg.d_model, cfg.d_model), 1.0 / np.sqrt(2 * cfg.d_model),
            g, dev)
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.mtp:
        groups["mtp_proj"] = layers.normal(
            (2 * cfg.d_model, cfg.d_model), 1.0 / np.sqrt(2 * cfg.d_model),
            g, dev)
        groups["mtp_block"] = init_dense_block(cfg, g, dev)
    return LM(cfg, groups)


def _attn_layers(params, cfg):
    """(block, is_moe) in layer order for the attention families and
    MoE."""
    if cfg.family == "moe":
        return ([(b, False) for b in getattr(params, "dense_blocks", [])]
                + [(b, True) for b in params.moe_blocks])
    return [(b, False) for b in params.blocks]


# ------------------------------------------------------------------ remat
def _save_no_batch_dots(ctx, op, *args, **kwargs):
    """`checkpoint_dots_with_no_batch_dims`: keep the outputs of matrix
    products without a batch dimension, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, remat):
    """fn, or fn under `torch.utils.checkpoint`: "full" keeps only its
    inputs and recomputes the rest in the backward; "dots" also keeps
    the outputs of its batch-free matrix products."""
    if remat == "none":
        return fn
    if remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False)
    if remat == "dots":
        return lambda *a: ckpt.checkpoint(
            fn, *a, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _save_no_batch_dots))
    raise ValueError(f"remat must be none, dots or full; got {remat!r}")


# ---------------------------------------------------------------- forward
def forward(params, cfg, batch, *, remat="none", with_aux=False):
    """Full-sequence forward. Returns logits [B, S', vocab], or (logits,
    the MoE aux loss summed over layers, f32) with `with_aux`. `remat`
    ("none", "dots", "full") checkpoints each block (each hybrid group)
    as the reference's scan body."""
    h = constrain(embed_inputs(params, cfg, batch), "dp", None, None)
    aux = torch.zeros((), device=h.device)
    if cfg.family == "ssm":
        block = _maybe_remat(mamba_block_train, remat)
        for blk in params.blocks:
            h = block(blk, h, cfg)
    elif cfg.family == "hybrid":
        h0 = h

        def group_apply(group, hh):
            for blk in group:
                hh = mamba_block_train(blk, hh, cfg)
            za, _, _ = dense_block_apply(params.shared,
                                         _shared_in(params, hh, h0), cfg)
            return hh + za
        group_apply = _maybe_remat(group_apply, remat)
        for group in params.blocks:
            h = group_apply(group, h)
    else:
        block = _maybe_remat(
            lambda blk, hh, is_moe: dense_block_apply(blk, hh, cfg,
                                                      is_moe)[:2], remat)
        for blk, is_moe in _attn_layers(params, cfg):
            h, a = block(blk, h, is_moe)
            aux = aux + a
    logits = lm_head(params, cfg, h)
    return (logits, aux) if with_aux else logits


# ------------------------------------------------------------------- loss
def cross_entropy(logits, labels, mask):
    if spmd.is_dtensor(logits):                  # vocabulary-parallel
        return spmd.cross_entropy(logits, labels, mask)
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


def loss_fn(params, cfg, batch, *, remat="none"):
    """Next-token cross entropy (audio: the frame labels; a VLM's patch
    positions excluded), plus DeepSeek's MTP loss at MTP_WEIGHT and
    0.01 * the MoE aux loss. Returns (loss, {"loss": loss, "aux":
    aux})."""
    logits, aux = forward(params, cfg, batch, remat=remat, with_aux=True)
    if cfg.family == "audio":
        labels = batch["labels"]
        loss = cross_entropy(logits, labels,
                             torch.ones(labels.shape, device=logits.device))
    else:
        tokens = batch["tokens"]
        npfx = cfg.n_patches
        lg = logits[:, npfx:-1] if npfx else logits[:, :-1]
        labels = tokens[:, 1:]
        loss = cross_entropy(lg, labels,
                             torch.ones(labels.shape, device=logits.device))
        if cfg.mtp:
            loss = loss + MTP_WEIGHT * _mtp_loss(params, cfg, batch, logits)
    loss = loss + 0.01 * aux
    return loss, {"loss": loss, "aux": aux}


def _mtp_loss(params, cfg, batch, main_logits):
    """DeepSeek-V3 multi-token prediction: predict t+2 from h_t ++ emb(t+1)
    (the embedding of the ground-truth next token, as in the paper's MTP
    module)."""
    tokens = batch["tokens"]
    h_in = _tokens(params, tokens[:, :-2])
    nxt = _tokens(params, tokens[:, 1:-1])
    z = layers.dense(torch.cat([h_in, nxt], dim=-1), params.mtp_proj)
    z, _, _ = dense_block_apply(params.mtp_block, z, cfg)
    logits = lm_head(params, cfg, z)
    labels = tokens[:, 2:]
    return cross_entropy(logits, labels,
                         torch.ones(labels.shape, device=logits.device))


# ------------------------------------------------------------------ cache
def make_cache(cfg, B, S, device=None) -> Dict[str, Any]:
    """Zeroed serving cache sized for S total positions."""
    device = resolve_device(device)
    c: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                            device=device)}
    L = cfg.n_layers

    def zeros(*shape, dtype=COMPUTE_DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("dense", "vlm") or (cfg.family == "moe"
                                          and cfg.attn_kind != "mla"):
        c["k"] = zeros(L, B, S, cfg.n_kv_heads, cfg.head_dim)
        c["v"] = torch.zeros_like(c["k"])
    elif cfg.family == "moe":
        c["k"] = zeros(L, B, S, cfg.kv_lora_rank)
        c["v"] = zeros(L, B, S, cfg.qk_rope_dim)
    elif cfg.family == "ssm":
        _, nheads, conv_dim = ssm.ssm_dims(cfg)
        c["ssm"] = zeros(L, B, nheads, cfg.ssm_head_dim, cfg.ssm_state,
                         dtype=torch.float32)
        c["conv"] = zeros(L, B, ssm.CONV_K - 1, conv_dim)
    elif cfg.family == "hybrid":
        _, nheads, conv_dim = ssm.ssm_dims(cfg)
        G, per = cfg.n_layers // cfg.hybrid_period, cfg.hybrid_period
        c["ssm"] = zeros(G, per, B, nheads, cfg.ssm_head_dim, cfg.ssm_state,
                         dtype=torch.float32)
        c["conv"] = zeros(G, per, B, ssm.CONV_K - 1, conv_dim)
        c["k"] = zeros(G, B, S, cfg.n_kv_heads, cfg.head_dim)
        c["v"] = torch.zeros_like(c["k"])
    return c


# ---------------------------------------------------------------- prefill
def prefill(params, cfg, batch):
    """Full-sequence forward that also builds the serving cache."""
    if cfg.family in ("encoder", "audio"):
        x = batch["frames"] if cfg.frame_dim else batch["tokens"]
        return forward(params, cfg, batch), {
            "len": torch.tensor(x.shape[1], dtype=torch.int32,
                                device=x.device)}
    h = constrain(embed_inputs(params, cfg, batch), "dp", None, None)
    cache: Dict[str, Any] = {"len": torch.tensor(h.shape[1],
                                                 dtype=torch.int32,
                                                 device=h.device)}
    parts: Dict[str, list] = {}

    def keep(**ts):
        for name, t in ts.items():
            parts.setdefault(name, []).append(t)

    if cfg.family == "ssm":
        for blk in params.blocks:
            h, s, conv = mamba_block_apply(blk, h, cfg)
            keep(ssm=s, conv=conv)
    elif cfg.family == "hybrid":
        h0 = h
        for group in params.blocks:
            s, cv = [], []
            for blk in group:
                h, s1, c1 = mamba_block_apply(blk, h, cfg)
                s.append(s1)
                cv.append(c1)
            z, _, (k, v) = dense_block_apply(params.shared,
                                             _shared_in(params, h, h0), cfg)
            h = h + z
            keep(ssm=torch.stack(s), conv=torch.stack(cv), k=k, v=v)
    else:
        for blk, is_moe in _attn_layers(params, cfg):
            h, _, (k, v) = dense_block_apply(blk, h, cfg, is_moe)
            keep(k=k, v=v)
    for name, ts in parts.items():
        cache[name] = torch.stack(ts)
    return lm_head(params, cfg, h), cache


# ----------------------------------------------------------------- decode
def decode_step(params, cfg, tokens, cache):
    """One decode step. tokens: [B, 1] integers. Returns (logits, cache);
    the cache's tensors are updated in place."""
    length = cache["len"]
    h = _tokens(params, tokens)
    if cfg.family == "ssm":
        for i, blk in enumerate(params.blocks):
            h, s, conv = mamba_block_decode(blk, h, cfg, cache["ssm"][i],
                                            cache["conv"][i])
            cache["ssm"][i].copy_(s)
            cache["conv"][i].copy_(conv)
    elif cfg.family == "hybrid":
        h0 = h
        for g, group in enumerate(params.blocks):
            for j, blk in enumerate(group):
                h, s, conv = mamba_block_decode(
                    blk, h, cfg, cache["ssm"][g, j], cache["conv"][g, j])
                cache["ssm"][g, j].copy_(s)
                cache["conv"][g, j].copy_(conv)
            z, _, _ = dense_block_decode(params.shared,
                                         _shared_in(params, h, h0), cfg,
                                         cache["k"][g], cache["v"][g],
                                         length)
            h = h + z
    else:
        for i, (blk, is_moe) in enumerate(_attn_layers(params, cfg)):
            h, _, _ = dense_block_decode(blk, h, cfg, cache["k"][i],
                                         cache["v"][i], length, is_moe)
    cache["len"] = length + 1
    return lm_head(params, cfg, h), cache


# --------------------------------------------------------------- counting
def param_counts(cfg):
    """(total, active-per-token) parameter counts for MODEL_FLOPS=6ND,
    reckoned on the meta device."""
    total = sum(p.numel() for p in init_params(cfg,
                                               device="meta").parameters())
    if cfg.family != "moe":
        return total, total
    # Active: total minus the non-selected experts' weights.
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    n_moe_layers = cfg.n_layers - cfg.n_dense_layers
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total, total - inactive
