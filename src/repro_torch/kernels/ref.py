"""Oracles for every kernel of the port (counterparts of
`repro.kernels.ref`): naive attention, the sequential SSD recurrence and
the sequential DHT insert/lookup."""
from __future__ import annotations

import math

import torch

EMPTY = -1
NEG_INF = -1e30


# ------------------------------------------------------ flash attention
def attention_ref(q, k, v, *, causal=True, window=None):
    """Naive attention. q: [B,Sq,H,dh]; k,v: [B,Skv,KV,dh]."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, Sq, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


# ------------------------------------------------------------- ssd scan
def ssd_ref(x, dt, A, B, C, *, init_state=None):
    """Sequential SSD recurrence (exact oracle).

    x: [b,S,H,P]; dt: [b,S,H]; A: [H]; B,C: [b,S,N].
    Returns y: [b,S,H,P], final state [b,H,P,N] (f32).
    """
    b, S, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    s = (torch.zeros(b, H, P, N, device=x.device) if init_state is None
         else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A[None])                # [b,H]
        s = (s * decay[..., None, None]
             + torch.einsum("bhp,bn,bh->bhpn", xf[:, t], Bf[:, t],
                            dtf[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    return torch.stack(ys, dim=1), s


# ------------------------------------------------------------ dht probe


def dht_insert_ref(table_keys, table_vals, keys, vals):
    """Sequential CAS-semantics oracle for the paper's §5.3 insert into
    ONE table block (`table_*` [TB], keys/vals [K]): each key CASes its
    slot in arrival order. Winners (empty slot) write; a key equal to the
    incumbent updates the value; everyone else reports overflow. Returns
    (keys', vals', status) with 0 = inserted, 1 = updated, 2 = overflow."""
    TB = table_keys.shape[0]
    tk, tv = table_keys.clone(), table_vals.clone()
    status = torch.empty(keys.shape, dtype=torch.int32)
    for i, (k, v) in enumerate(zip(keys.tolist(), vals.tolist())):
        slot = k % TB
        cur = int(tk[slot])
        if cur == EMPTY:
            tk[slot], tv[slot], status[i] = k, v, 0
        elif cur == k:
            tv[slot], status[i] = v, 1
        else:
            status[i] = 2
    return tk, tv, status


def dht_lookup_ref(table_keys, table_vals, keys):
    """Oracle lookup in one block: the value at the key's slot if the
    key matches, else EMPTY (the caller then searches the overflow
    heap)."""
    slots = torch.remainder(keys, table_keys.shape[0]).long()
    hit = table_keys[slots] == keys
    return torch.where(hit, table_vals[slots], EMPTY).to(torch.int32), hit
