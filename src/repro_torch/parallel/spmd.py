"""Model ops on DTensors, written per rank on its local shards.

DTensor's sharding propagation plans most of the model, but a few ops
need a plan of their own: a gather along a sharded vocabulary (the loss),
decode attention's 5-D products (whose strategy search on a 3-D mesh
takes minutes per op) and its cache write at a data-dependent position
of a possibly sharded sequence, and the MoE dispatch (`models/moe.py`).
These run on each rank's local shards with explicit collectives, as
DTensor's `from_local` / `redistribute` (so autograd and the collective
counters see them):

- `matmul`, `embedding`, `depthwise`: tensor- and ZeRO-3-parallel
  products, a vocabulary-parallel lookup and a per-channel convolution,
  planned by rule (DTensor's own search for `mm` takes seconds per call
  on a 3-D mesh, and torch 2.11's DTensor cannot pad a sharded tensor).
- `cross_entropy`: vocabulary-parallel (each rank's max, sum of
  exponentials and gold logit over its vocabulary slice, all-reduced
  over the vocabulary's mesh dims), then the batch mean all-reduced.
- `decode_attention` / `cache_write`: sharded over the batch, the KV
  heads (where both head counts divide) and the cached positions; a
  sharded sequence combines its ranks' partial softmax (all-reduce of
  the max, then of the rescaled sums and outputs).
- `attention` / `ssd`: the kernels' DTensor rule. Both are
  embarrassingly parallel over the batch and the heads, so a call keeps
  each mesh dim's sharding of those dims and redistributes every other
  placement to a replica: attention shards q, k and v's batch, and the
  KV heads beside q's where both head counts divide by the heads' mesh
  size (query head h reads KV head h // (H // KV), so contiguous blocks
  of both line up); the scan shards x, dt, A, y and the final state
  over the heads and replicates B and C. The kernel runs on the local
  shards (launching on a card, its plain version on the CPU, its meta
  path on the meta device).

The meta-device dry run (`launch/dryrun.py`) drives these on a fake
world; a state placed on a mesh of real ranks (`Trainer(mesh=)`, the
pod-sharded `parallel.hierarchical` step) drives them with real
collectives (gloo on the CPU, NCCL on cards). The helpers below them
(`to_local`, `like`, `placed_like`, `full`, `mesh_context`) let the
optimizer and the train steps take the same code on and off a mesh.
"""
from __future__ import annotations

import contextlib
import math
import sys

import torch


def is_dtensor(t) -> bool:
    """Whether t is a DTensor (False without importing DTensor when
    nothing has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def to_local(t):
    """DTensor t's local shard (a view of its storage), a plain tensor
    as it is."""
    return t.to_local() if is_dtensor(t) else t


def like(local_t, ref):
    """`local_t` as a DTensor with `ref`'s mesh and placements where ref
    is a DTensor (local_t its rank's shard), else as it is."""
    if not is_dtensor(ref):
        return local_t
    return wrap(local_t, ref.device_mesh, ref.placements, tuple(ref.shape))


def placed_like(g, p):
    """Gradient g under its parameter p's placements (a Partial one
    reduced once); a plain g as it is."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def full(t):
    """DTensor t as a whole plain tensor (a gather where it is sharded,
    a reduction where Partial), a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


@contextlib.contextmanager
def mesh_context(t):
    """Where t is a DTensor, runs the block as a step on its mesh does:
    plain tensors taken as replicated (`implicit_replication`) and the
    model's logical axes mapped to the mesh's (`constrain`'s multi-pod
    rules on a mesh with 'pod', else the single-pod ones); else
    nothing."""
    if not is_dtensor(t):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.parallel import constrain as con
    rules = (con.rules_multi_pod() if "pod" in t.device_mesh.mesh_dim_names
             else con.rules_single_pod())
    with implicit_replication(), con.logical_axis_rules(rules):
        yield


def mesh_dims(t, pred):
    """The mesh dims of DTensor t whose placement satisfies pred."""
    return [i for i, p in enumerate(t.placements) if pred(p)]


def size(mesh, dims) -> int:
    """The number of ranks along mesh dims `dims`."""
    return math.prod(mesh.size(i) for i in dims)


def reduce(local, mesh, dims, op: str = "sum"):
    """`local` all-reduced (op: "sum", "avg", "max") over mesh dims
    `dims`, as a plain tensor (differentiable for sum and avg)."""
    if not dims:
        return local
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial(op) if i in dims else Replicate()
          for i in range(mesh.ndim)]
    return DTensor.from_local(local, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def local(t, placements, grad=None):
    """DTensor t's local shard under `placements` (differentiable). The
    gradient that flows back into it has placements `grad` (default:
    `placements`): Partial where the rank's local gradient is its share
    of a sum, e.g. a weight gathered over the mesh dims that shard the
    tokens."""
    return t.redistribute(t.device_mesh, placements).to_local(
        grad_placements=grad or placements)


def as_local(t, mesh, placements):
    """t's local shard under `placements`: a DTensor redistributed, a
    plain (global, replicated) tensor chunked."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(t, DTensor):
        t = distribute_tensor(t, mesh, placements, src_data_rank=None)
    return local(t, placements)


def offset(t_shape, mesh, placements):
    """This rank's global offset of its local shard, per tensor dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(t_shape, mesh,
                                                 placements)[1]


def wrap(local_t, mesh, placements, shape):
    """A DTensor of global `shape` (contiguous) from this rank's local
    shard."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local_t.contiguous(), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def split_heads(t, heads: int, dh: int):
    """t [..., heads * dh] reshaped to [..., heads, dh]; a DTensor whose
    last dim is sharded over mesh dims that do not divide `heads` is
    replicated over those first (DTensor cannot split an uneven shard)."""
    from torch.distributed.tensor import Replicate
    pl, n = list(t.placements), 1
    for i, p in enumerate(pl):
        if p.is_shard(t.ndim - 1):
            if heads % (n * t.device_mesh.size(i)):
                pl[i] = Replicate()
            else:
                n *= t.device_mesh.size(i)
    if pl != list(t.placements):
        t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:-1], heads, dh)


# ------------------------------------------------------------ products
def matmul(x, w):
    """x [..., K] @ w [K, N] on DTensors, planned per mesh dim as
    tensor and ZeRO-3 parallelism do (a Partial input is reduced first):

    - x sharded on a leading dim (the batch): w is gathered there, the
      output keeps x's sharding;
    - x replicated: w's sharding of N gives a column-parallel output
      sharded on N; its sharding of K a row-parallel Partial output (x
      chunked on K locally); a replicated w a replicated output;
    - x sharded on K: a K-sharded w gives a Partial output, an N-sharded
      one gathers x first (column-parallel), a replicated one is chunked
      on K locally (Partial output).

    A Partial (row-parallel) output is all-reduced at once, in its own
    dtype, as Megatron's row-parallel layer does; in the backward, the
    weight's gradient is summed over the mesh dims that shard the
    tokens and x's over those that shard N. DTensor's own strategy
    search for `mm` takes seconds per call on a 3-D mesh; this plan is
    the layout's without a search."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    xp, wp, op, xg, wg = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_partial():
            a = Replicate()
        if a.is_shard() and a.dim % x.ndim != last:
            d = Shard(a.dim % x.ndim)
            xp.append(d), wp.append(Replicate()), op.append(d)
            xg.append(d), wg.append(Partial())
        elif b.is_shard(1):
            xp.append(Replicate()), wp.append(Shard(1)), op.append(Shard(last))
            xg.append(Partial()), wg.append(Shard(1))
        elif b.is_shard(0) or a.is_shard():
            xp.append(Shard(last)), wp.append(Shard(0)), op.append(Partial())
            xg.append(Shard(last)), wg.append(Shard(0))
        else:
            xp.append(Replicate()), wp.append(Replicate())
            op.append(Replicate()), xg.append(Replicate())
            wg.append(Replicate())
    out = wrap(local(x, tuple(xp), tuple(xg)) @ local(w, tuple(wp), tuple(wg)),
               mesh, tuple(op), tuple(x.shape[:-1]) + (w.shape[1],))
    if any(p.is_partial() for p in op):
        out = out.redistribute(mesh, tuple(
            Replicate() if p.is_partial() else p for p in op))
    return out


def depthwise(fn, x, w, b):
    """fn(x, w, b) on DTensors x [B, S, C], w [K, C], b [C] (a causal
    depthwise convolution along S), per rank: the batch and the
    channels stay sharded where x has them (w and b follow the
    channels), S is replicated; the output keeps x's placements. w's and
    b's gradients are summed over the batch's mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    xp, wp, bp, wg, bg = [], [], [], [], []
    for a in x.placements:
        if a.is_shard() and a.dim % x.ndim == 0:
            xp.append(Shard(0)), wp.append(Replicate())
            bp.append(Replicate()), wg.append(Partial()), bg.append(Partial())
        elif a.is_shard() and a.dim % x.ndim == last:
            xp.append(Shard(last)), wp.append(Shard(1)), bp.append(Shard(0))
            wg.append(Shard(1)), bg.append(Shard(0))
        else:
            xp.append(Replicate()), wp.append(Replicate())
            bp.append(Replicate()), wg.append(Replicate())
            bg.append(Replicate())
    out = fn(local(x, tuple(xp)), local(w, tuple(wp), tuple(wg)),
             local(b, tuple(bp), tuple(bg)))
    return wrap(out, mesh, tuple(xp), tuple(x.shape))


def pad_last(t, n: int):
    """t with n zeros appended to its last dim; a DTensor is padded per
    rank, its last dim replicated first (torch 2.11's DTensor cannot
    pad a sharded tensor)."""
    from torch.distributed.tensor import Replicate
    from torch.nn import functional as F
    if not is_dtensor(t):
        return F.pad(t, (0, n))
    pl = tuple(Replicate() if p.is_partial() or (
        p.is_shard() and p.dim % t.ndim == t.ndim - 1) else p
        for p in t.placements)
    return wrap(F.pad(local(t, pl), (0, n)), t.device_mesh, pl,
                tuple(t.shape[:-1]) + (t.shape[-1] + n,))


def embedding(table, ids):
    """table[ids] on DTensors, vocabulary-parallel: where the vocabulary
    (dim 0) is sharded, each rank looks up the ids its slice holds
    (zeros elsewhere) and the output is Partial; where the ids' batch is
    sharded it stays so (the table gathered there); where only the
    model dim is sharded, so is the output's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    ids_pl = getattr(ids, "placements", (Replicate(),) * mesh.ndim)
    tp, ip, op, tg = [], [], [], []
    for t, d in zip(table.placements, ids_pl):
        if t.is_shard(0):
            tp.append(Shard(0)), ip.append(Replicate()), op.append(Partial())
            tg.append(Shard(0))
        elif d.is_shard(0):
            tp.append(Replicate()), ip.append(Shard(0)), op.append(Shard(0))
            tg.append(Partial())
        elif t.is_shard(1):
            tp.append(Shard(1)), ip.append(Replicate())
            op.append(Shard(ids.ndim)), tg.append(Shard(1))
        else:
            tp.append(Replicate()), ip.append(Replicate())
            op.append(Replicate()), tg.append(Replicate())
    tl = local(table, tuple(tp), tuple(tg))
    il = as_local(ids, mesh, tuple(ip)).long()
    v0 = offset(tuple(table.shape), mesh, tuple(tp))[0]
    own = (il >= v0) & (il < v0 + tl.shape[0])
    out = tl[(il - v0).clamp(0, max(tl.shape[0] - 1, 0))] * own[..., None]
    return wrap(out, mesh, tuple(op), tuple(ids.shape) + (table.shape[1],))


# ----------------------------------------------------------------- loss
def cross_entropy(logits, labels, mask):
    """`models.lm.cross_entropy` on DTensor logits [B, S, V]: the batch
    stays sharded where it is, the vocabulary (last dim) stays sharded
    where it is, everything else is replicated first. Returns the loss
    as a replicated 0-dim DTensor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    last = logits.ndim - 1
    pl = tuple(Shard(0) if p.is_shard(0) else
               Shard(last) if p.is_shard(last) else Replicate()
               for p in logits.placements)
    vocab = [i for i, p in enumerate(pl) if p.is_shard(last)]
    batch = [i for i, p in enumerate(pl) if p.is_shard(0)]
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    lg = local(logits, pl).float()
    lab = as_local(labels, mesh, rows).long()
    msk = as_local(mask, mesh, rows)
    v0, vl = offset(tuple(logits.shape), mesh, pl)[last], lg.shape[-1]
    m = reduce(lg.detach().amax(dim=-1), mesh, vocab, "max")
    lse = m + torch.log(reduce(torch.exp(lg - m[..., None]).sum(-1), mesh,
                               vocab))
    own = (lab >= v0) & (lab < v0 + vl)
    idx = (lab - v0).clamp(0, max(vl - 1, 0))
    gold = reduce(torch.gather(lg, -1, idx[..., None])[..., 0] * own, mesh,
                  vocab)
    num = reduce(((lse - gold) * msk).sum(), mesh, batch)
    den = reduce(msk.sum(), mesh, batch)
    return wrap(num / torch.clamp_min(den, 1), mesh,
                (Replicate(),) * mesh.ndim, ())


def argmax(logits):
    """logits.argmax(dim=-1) on a DTensor [B, V], vocabulary-parallel:
    each rank's best logit and index over its slice, the largest logit
    all-reduced (max) and, among the ranks that hold it, the lowest
    index (min), as torch's argmax picks. The batch keeps its
    sharding."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = logits.device_mesh
    pl = tuple(Shard(1) if p.is_shard(1) else
               Shard(0) if p.is_shard(0) else Replicate()
               for p in logits.placements)
    vocab = [i for i, p in enumerate(pl) if p.is_shard(1)]
    lg = local(logits, pl)
    v0 = offset(tuple(logits.shape), mesh, pl)[1]
    best, idx = lg.max(dim=-1)
    top = reduce(best, mesh, vocab, "max")
    idx = torch.where(best == top, idx + v0, logits.shape[1])
    out = reduce(idx, mesh, vocab, "min")
    return wrap(out, mesh, tuple(Shard(0) if p.is_shard(0) else Replicate()
                                 for p in pl), (logits.shape[0],))


# --------------------------------------------------------------- decode
def _plan(t, heads, head_counts=(), seq=None):
    """Per mesh dim of DTensor t: "batch" (its dim 0), "seq" (dim
    `seq`), "heads" (dim `heads`, where every count of head_counts
    divides by the heads' mesh size) or None (replicated)."""
    mesh, plan, n = t.device_mesh, [], 1
    for i, p in enumerate(t.placements):
        size = mesh.size(i)
        if p.is_shard(0):
            plan.append("batch")
        elif seq is not None and p.is_shard(seq):
            plan.append("seq")
        elif (heads is not None and p.is_shard(heads)
              and all(h % (n * size) == 0 for h in head_counts)):
            plan.append("heads")
            n *= size
        else:
            plan.append(None)
    return plan


def _placements(plan, **dims):
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(dims[k]) if k in dims else Replicate() for k in plan)


def cache_write(cache, at, new, n_heads: int):
    """cache[:, at] = new, in place, for a DTensor cache [B, S, ...]
    (at: a 1-element integer tensor, new [B, 1, ...]): each rank writes
    the position if its slice of S holds it."""
    mesh = cache.device_mesh
    plan = _plan(cache, 2 if cache.ndim == 4 else None,
                 (cache.shape[2], n_heads), seq=1)
    if tuple(cache.placements) != _placements(plan, batch=0, seq=1, heads=2):
        raise ValueError(f"cache_write: cache placements {cache.placements} "
                         "shard a dim other than batch, seq and heads")
    c = cache.to_local()
    n = as_local(new, mesh, _placements(plan, batch=0, heads=2)).to(c.dtype)
    at = as_local(at, mesh, _placements(plan)).long()
    s0, sl = offset(tuple(cache.shape), mesh, cache.placements)[1], c.shape[1]
    pos = at - s0
    own = (pos >= 0) & (pos < sl)
    pos = pos.clamp(0, max(sl - 1, 0))
    keep = c.index_select(1, pos)
    c.index_copy_(1, pos, torch.where(
        own.reshape((1, 1) + (1,) * (c.ndim - 2)), n, keep))
    return cache


def decode_attention(q, k_cache, v_cache, length, *, window=None):
    """`models.layers.decode_attention` on DTensors (q [B,1,H,Dh], caches
    [B,S,KV,Dh], length a 0-dim tensor): sharded over batch, KV heads and
    cached positions as the caches are; ranks sharing a sequence combine
    their partial softmax. Returns [B,1,H,Dh] in q's dtype."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = k_cache.device_mesh
    B, S, KV, Dh = k_cache.shape
    H = q.shape[2]
    plan = _plan(k_cache, 2, (KV, H), seq=1)
    kv_pl = _placements(plan, batch=0, seq=1, heads=2)
    q_pl = _placements(plan, batch=0, heads=2)
    seq = [i for i, k in enumerate(plan) if k == "seq"]
    ql = local(q, q_pl)
    kl, vl = local(k_cache, kv_pl), local(v_cache, kv_pl)
    s0 = offset((B, S, KV, Dh), mesh, kv_pl)[1]
    length = as_local(length, mesh, _placements(plan))
    b, sl, kvl, _ = kl.shape
    G = H // KV
    qs = ql.reshape(b, 1, kvl, G, Dh).float() * (1.0 / math.sqrt(Dh))
    s = torch.einsum("bqkgd,bskd->bkgqs", qs, kl.float())
    pos = s0 + torch.arange(sl, device=ql.device)
    valid = pos < length
    if window is not None:
        valid &= pos > (length - 1 - window)
    s = torch.where(valid, s, -1e30)
    m = reduce(s.amax(dim=-1, keepdim=True), mesh, seq, "max")
    p = torch.exp(s - m)
    den = reduce(p.sum(dim=-1, keepdim=True), mesh, seq)
    acc = reduce(torch.einsum("bkgqs,bskd->bkgqd", p, vl.float()), mesh, seq)
    out = (acc / den).permute(0, 3, 1, 2, 4).reshape(b, 1, kvl * G, Dh)
    return wrap(out.to(q.dtype), mesh, q_pl, tuple(q.shape))


# -------------------------------------------------------------- kernels
def attention(fn, q, k, v, **kwargs):
    """fn(q, k, v, **kwargs) on DTensors q [B,Sq,H,dh], k/v
    [B,Skv,KV,dh], per rank, sharded over batch and heads."""
    pl = _placements(_plan(q, 2, (q.shape[2], k.shape[2])), batch=0,
                     heads=2)
    out = fn(*(local(t, pl).contiguous() for t in (q, k, v)), **kwargs)
    return wrap(out, q.device_mesh, pl, tuple(q.shape))


def ssd(fn, x, dt, A, B, C, **kwargs):
    """fn(x, dt, A, B, C, **kwargs) -> (y, state) on DTensors x
    [b,S,H,P], dt [b,S,H], A [H], B/C [b,S,N], per rank, sharded over
    batch and heads."""
    plan = _plan(x, 2, (x.shape[2],))
    xp = _placements(plan, batch=0, heads=2)
    bp = _placements(plan, batch=0)
    y, state = fn(local(x, xp).contiguous(), local(dt, xp).contiguous(),
                  local(A, _placements(plan, heads=0)).contiguous(),
                  local(B, bp).contiguous(), local(C, bp).contiguous(),
                  **kwargs)
    b, _, H, P = x.shape
    return (wrap(y, x.device_mesh, xp, tuple(x.shape)),
            wrap(state, x.device_mesh, _placements(plan, batch=0, heads=1),
                 (b, H, P, B.shape[-1])))
