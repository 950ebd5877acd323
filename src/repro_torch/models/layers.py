"""Shared model primitives: plain functions on tensors over nested dicts of
parameters, the subset of ``repro.models.layers`` that the ported models
need.

Conventions (as in the JAX package): activations compute in ``x.dtype``;
dense weights keep the JAX ``(d_in, d_out)`` layout, so ``y = x @ w``.  An
init function takes a ``torch.Generator`` (``None`` on the meta device, where
only shapes are made) and the device.

Attention is plain tensor code (einsum, softmax), as the JAX package
computes it outside any kernel.  Where JAX promotes a mixed bf16/f32
einsum to f32 (bf16 queries over an f32 cache), the port casts explicitly
in the same places: ``torch.einsum`` does not promote.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import context as dist_context

Params = dict

__all__ = [
    "Params",
    "normal",
    "dense_init",
    "dense_apply",
    "rope_freqs",
    "apply_rope",
    "dense_attention",
    "flash_attention",
    "banded_attention",
    "attention_any",
    "pad_heads_for_tp",
    "tp_heads",
    "seq_split_attention",
    "split_offset",
    "write_positions",
    "gqa_init",
    "gqa_apply",
    "gqa_init_cache",
    "swiglu_init",
    "swiglu_apply",
    "rmsnorm_init",
    "rmsnorm_apply",
    "embed_init",
    "embed_apply",
    "unembed_apply",
]


def normal(gen: torch.Generator | None, shape: tuple[int, ...], scale: float,
           device: torch.device) -> torch.Tensor:
    """float32 N(0, scale^2), drawn from ``gen`` on ``device``."""
    return torch.randn(shape, generator=gen, device=device).mul_(scale)


def dense_init(gen, d_in: int, d_out: int, device: torch.device, *,
               scale: float | None = None, bias: bool = False) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal(gen, (d_in, d_out), scale, device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"g": torch.ones(d, device=device)}


def rmsnorm_apply(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["g"].to(x.dtype)


def embed_init(gen, vocab: int, d_model: int, device: torch.device) -> Params:
    return {"table": normal(gen, (vocab, d_model), 0.02, device)}


def embed_apply(p: Params, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # gather, then cast: the same numbers as casting the table first, without
    # a copy of the whole table
    return F.embedding(tokens.long(), p["table"]).to(dtype)


def unembed_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (S,).  Rotates in f32 and
    returns ``x.dtype``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (D/2,)
    ang = positions.to(torch.float32)[:, None] * freqs            # (S, D/2)
    cos = torch.cos(ang)[:, None, :]                              # (S, 1, D/2)
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention strategies
# ---------------------------------------------------------------------------

_NEG = -1e30


def _expand_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, S, Hkv, G, D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _promoted(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Both operands in their promoted dtype, as ``jnp.einsum`` computes a
    mixed product (bf16 with f32 is f32)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def dense_attention(
    q: torch.Tensor,                 # (B, Sq, Hq, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: int | None = None,
) -> torch.Tensor:
    """Reference attention with the scores materialised; GQA by head
    grouping.  ``q_offset`` is the absolute position of q[0]; ``kv_len``
    masks cache entries beyond the valid length."""
    n_kv = k.shape[2]
    qg, kk = _promoted(_expand_gqa(q, n_kv), k)                  # B Sq Hkv G D
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kk) * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    logits = torch.where(mask, logits.float(), _NEG)
    probs, vv = _promoted(torch.softmax(logits, dim=-1).to(q.dtype), v)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vv)
    b, _, hkv, g, dv = out.shape
    return out.reshape(b, sq, hkv * g, dv)


def flash_attention(
    q: torch.Tensor,                 # (B, Sq, Hq, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax blockwise attention, as the JAX package's
    ``flash_attention`` computes it: per block of ``q_chunk`` queries, the
    running max ``m``, sum ``l`` and output ``acc`` in f32 over blocks of
    ``kv_chunk`` keys; ``p`` in the query dtype for the PV product.  Live
    scores are O(q_chunk x kv_chunk), not O(Sq x Sk).  Causal q blocks skip
    the kv blocks wholly after them: there every score is ``_NEG`` below a
    finite ``m`` (block 0 holds key 0, which every query sees), so the
    reference's update adds exact zeros and scales by exactly 1."""
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide the lengths ({sq}, {sk})")
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qs = q.reshape(b, sq // q_chunk, q_chunk, hkv, g, d)
    kpos_all = torch.arange(sk, device=q.device)
    blocks = []
    for qi in range(sq // q_chunk):
        qb = qs[:, qi]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hkv, g, q_chunk), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dv), dtype=torch.float32, device=q.device)
        for lo in range(0, sk, kv_chunk):
            if causal and lo >= (qi + 1) * q_chunk:
                break
            kb, vb = k[:, lo:lo + kv_chunk], v[:, lo:lo + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).float() * scale
            if causal:
                s = torch.where(qpos[:, None] >= kpos_all[None, lo:lo + kv_chunk], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(qb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, dv).to(q.dtype))
    return torch.cat(blocks, dim=1)


def banded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int,
    q_chunk: int = 1024,
) -> torch.Tensor:
    """Causal local attention visiting only the in-window band: each chunk
    of ``q_chunk`` queries sees a slice of ``window + q_chunk`` keys, so the
    work is O(S * window), not O(S^2)."""
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    q_chunk = min(q_chunk, sq)
    if sq % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} does not divide the length {sq}")
    if sq != sk:
        raise ValueError("banded attention is self-attention (Sq == Sk)")
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    band = window + q_chunk

    # left-pad keys so every slice is in bounds
    kp = F.pad(k, (0, 0, 0, 0, band - q_chunk, 0))
    vp = F.pad(v, (0, 0, 0, 0, band - q_chunk, 0))
    qs = q.reshape(b, sq // q_chunk, q_chunk, hkv, g, d)
    blocks = []
    for qi in range(sq // q_chunk):
        start = qi * q_chunk     # padded slice [start, start + band) holds kv start - window ..
        kb = kp[:, start:start + band]
        vb = vp[:, start:start + band]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs[:, qi], kb).float() * scale
        qpos = start + torch.arange(q_chunk, device=q.device)
        kpos = start - window + torch.arange(band, device=q.device)
        mask = ((qpos[:, None] >= kpos[None, :])
                & (qpos[:, None] - kpos[None, :] < window)
                & (kpos[None, :] >= 0))
        p = torch.softmax(torch.where(mask, s, _NEG), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), vb)
        blocks.append(out.reshape(b, q_chunk, hq, dv))
    return torch.cat(blocks, dim=1)


def _largest_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c:
        c -= 1
    return c


_FLASH_THRESHOLD = 2048


def attention_any(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """The attention strategy for the shapes at hand, as the JAX package
    picks it: dense up to ``2048^2 / 4`` scores, banded for local
    self-attention above, flash otherwise."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == 1 or sq * sk <= _FLASH_THRESHOLD * _FLASH_THRESHOLD // 4:
        return dense_attention(q, k, v, causal=causal, window=window)
    if window > 0 and sq == sk:
        qc = _largest_chunk(sq, min(1024, window))
        return banded_attention(q, k, v, window=window, q_chunk=qc)
    return flash_attention(q, k, v, causal=causal, q_chunk=_largest_chunk(sq, 1024),
                           kv_chunk=_largest_chunk(sk, 1024))


# ---------------------------------------------------------------------------
# attention heads split over the model axis
# ---------------------------------------------------------------------------


def pad_heads_for_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dm: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The reference's padded-TP head layout for ``dm`` ranks along
    ``model``, exact for any head count: kv heads are repeated ``rep =
    lcm(KV, dm) / KV`` times; each group's q heads are zero-padded from
    ``gq = H / KV`` to ``gq_pad = rep * ceil(gq / rep)``.  Group-major
    order is kept, so padded q slot ``r * gq_pad + o`` attends padded kv
    head ``r * rep + o // (gq_pad / rep)``, a copy of real kv head ``r``.
    Returns (q_pad, k_rep, v_rep, gq_pad); both padded head counts are
    multiples of ``dm``."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    rep = math.lcm(kv, dm) // kv
    gq_pad = rep * (-(-g // rep))
    q_pad = F.pad(q.reshape(b, s, kv, g, d), (0, 0, 0, gq_pad - g)).reshape(b, s, kv * gq_pad, d)
    return (q_pad, k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2), gq_pad)


def tp_heads(n_heads: int, n_kv: int, dm: int, coord: int) -> tuple[list[int], list[int]]:
    """Rank ``coord`` of ``dm`` along ``model``: its block of the
    :func:`pad_heads_for_tp` layout, as the real q head in each of its q
    slots (-1 for a pad) and the real kv head in each of its kv slots.
    Without padding (``n_heads`` and ``n_kv`` multiples of ``dm``) that is
    the ``coord``-th contiguous block of each."""
    q = torch.arange(1, n_heads + 1, dtype=torch.float64).view(1, 1, n_heads, 1)
    kv = torch.arange(n_kv, dtype=torch.float64).view(1, 1, n_kv, 1)
    q_pad, kv_rep, _, _ = pad_heads_for_tp(q, kv, kv, dm)
    nq, nk = q_pad.shape[2] // dm, kv_rep.shape[2] // dm
    return ([int(h) - 1 for h in q_pad[0, 0, coord * nq:(coord + 1) * nq, 0]],
            [int(h) for h in kv_rep[0, 0, coord * nk:(coord + 1) * nk, 0]])


def _head_slots(p: Params, x: torch.Tensor, heads: list[int], head_dim: int) -> torch.Tensor:
    """``x``'s projection by the dense layer ``p`` (head-major outputs) for
    the heads ``heads`` only, (B, S, len(heads), head_dim): a pad (-1)
    projects to zeros."""
    d_in = p["w"].shape[0]
    w = p["w"].view(d_in, -1, head_dim)
    n = w.shape[1]
    idx = torch.tensor([h if h >= 0 else n for h in heads], device=w.device)
    sub = {"w": torch.cat([w, w.new_zeros(d_in, 1, head_dim)], dim=1)[:, idx].reshape(d_in, -1)}
    if "b" in p:
        b = p["b"].view(n, head_dim)
        sub["b"] = torch.cat([b, b.new_zeros(1, head_dim)])[idx].reshape(-1)
    return dense_apply(sub, x).reshape(*x.shape[:-1], len(heads), head_dim)


def _attend_tp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_heads: list[int], *,
               causal: bool, window: int = 0) -> torch.Tensor:
    """Attention over one rank's block of the padded-TP layout (``q`` its q
    slots, ``k`` and ``v`` its kv slots, ``q_heads`` as :func:`tp_heads`
    gives them): the outputs of its real q heads, (B, S, n_real, D) in
    slot order, the pads' sliced away."""
    out = attention_any(q, k, v, causal=causal, window=window)
    return out[:, :, [i for i, h in enumerate(q_heads) if h >= 0]]


def _gqa_tp(p: Params, x: torch.Tensor, ctx, *, n_heads: int, n_kv: int, head_dim: int,
            causal: bool, window: int, rope_theta: float,
            kv_source: torch.Tensor | None = None) -> torch.Tensor:
    """``gqa_apply``'s uncached forward in a ``model``-parallel region:
    this rank's q heads (:func:`tp_heads`) with the kv heads they read,
    its rows of ``wo``, and the sum of the ranks' parts over ``model``.
    With ``kv_source``, cross-attention as the reference's ``_attend_tp``
    lays it out: k and v projected from the context, which enters the
    region as ``x`` does, no rotation."""
    b, s, _ = x.shape
    q_heads, kv_heads = tp_heads(n_heads, n_kv, ctx.model_size, ctx.model_coord)
    xr = ctx.enter(x)
    src = xr if kv_source is None else ctx.enter(kv_source)
    q = _head_slots(p["wq"], xr, q_heads, head_dim)
    k = _head_slots(p["wk"], src, kv_heads, head_dim)
    v = _head_slots(p["wv"], src, kv_heads, head_dim)
    if kv_source is None:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    out = _attend_tp(q, k, v, q_heads, causal=causal, window=window).to(x.dtype)
    return _wo_rows(p, out, q_heads, ctx, n_heads=n_heads, head_dim=head_dim)


def _wo_rows(p: Params, out: torch.Tensor, q_heads: list[int], ctx, *, n_heads: int,
             head_dim: int) -> torch.Tensor:
    """The output projection of one rank's real q heads, ``out`` (B, S,
    n_real, D) in the residual's dtype: its rows of ``wo``, summed over
    ``model`` in f32 (the region's exit)."""
    b, s = out.shape[:2]
    rows = p["wo"]["w"].view(n_heads, head_dim, -1)[[h for h in q_heads if h >= 0]]
    y = out.reshape(b, s, -1) @ rows.reshape(out.shape[2] * head_dim, -1).to(out.dtype)
    return ctx.exit(y.to(dist_context.wide(y.dtype))).to(out.dtype)


# ---------------------------------------------------------------------------
# a cache whose sequence is split over the model axis
# ---------------------------------------------------------------------------


def write_positions(buf: torch.Tensor, new: torch.Tensor, start: int, lo: int = 0) -> None:
    """Write ``new`` (B, s, ...), the entries of global positions ``start``
    to ``start + s``, into ``buf`` (B, L, ...), which holds positions
    ``lo`` to ``lo + L``: the part that falls there (a write that
    straddles two shards of a split cache lands half in each), in place."""
    first = max(start, lo)
    end = min(start + new.shape[1], lo + buf.shape[1])
    if first < end:
        buf[:, first - lo:end - lo] = new[:, first - start:end - start].to(buf.dtype)


def seq_split_attention(
    q: torch.Tensor,                 # (B, Sq, Hq, D), every head
    k: torch.Tensor,                 # (B, L, Hkv, D): this rank's positions lo .. lo + L
    v: torch.Tensor,                 # (B, L, Hkv, Dv)
    ctx,
    *,
    lo: int,
    q_offset: int,
    kv_len: int,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """``dense_attention`` over a cache whose sequence is split over
    ``model``, each rank holding ``L`` positions from ``lo``: every rank
    attends its own positions with ``flash_attention``'s online-softmax
    arithmetic (the running max ``m``, sum ``l`` and output ``acc`` in f32,
    masked scores at the finite ``_NEG``; a masked position's weight is an
    exact 0, so a shard with no valid position yet contributes ``l = 0``
    and ``acc = 0``), the ranks' ``(m, l, acc)`` are all-gathered over
    ``model`` (``ctx.gather_model``) and merged in rank order, scaled to
    the largest ``m``, and ``acc / max(l, 1e-30)`` ends it: every rank
    holds the same bits.  The causal mask, ``window`` and ``kv_len`` are
    taken at the rank's positions.  Returns (B, Sq, Hq, Dv) in the
    promoted dtype of ``q`` and ``v``, as ``dense_attention`` does."""
    b, sq, hq, d = q.shape
    n_kv, dv = k.shape[2], v.shape[-1]
    acc_dt = dist_context.wide(q.dtype)
    qg, kk = _promoted(_expand_gqa(q, n_kv), k)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kk).to(acc_dt) / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device) + lo
    mask = (kpos < kv_len)[None, :].expand(sq, -1)
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window > 0:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    s = torch.where(mask, s, _NEG)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    del s
    pp, vv = _promoted(p.to(q.dtype), v)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", pp, vv).to(acc_dt)
    parts = ctx.gather_model(torch.cat([m[..., None], p.sum(dim=-1)[..., None], acc], dim=-1))
    del p, pp, acc
    m_all = parts[..., 0].amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc_all = torch.zeros_like(parts[0, ..., 2:])
    for part in parts:                  # rank order: the same bits on every rank
        corr = torch.exp(part[..., 0] - m_all)
        l_all = l_all + part[..., 1] * corr
        acc_all = acc_all + part[..., 2:] * corr[..., None]
    out = acc_all / torch.clamp_min(l_all[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(torch.promote_types(q.dtype,
                                                                                  v.dtype))


def split_offset(cache: Params, ctx, length: int) -> int:
    """The first position this rank's part of a cache holds: 0 for a whole
    cache, ``model`` coordinate x ``length`` for one split over ``model``
    in ``cache["seq_shards"]`` parts (``train_step.init_local_cache``),
    which needs a distribution context of that many ``model`` ranks."""
    shards = cache.get("seq_shards", 1)
    if shards == 1:
        return 0
    if ctx is None or ctx.model_size != shards:
        raise ValueError(f"a cache split over {shards} model ranks, under "
                         f"{'no distribution context' if ctx is None else ctx.sizes}")
    return ctx.model_coord * length


# ---------------------------------------------------------------------------
# GQA attention block (params + apply), with KV cache
# ---------------------------------------------------------------------------


def gqa_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             device: torch.device, *, bias: bool = False) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, device, bias=bias),
        "wk": dense_init(gen, d_model, n_kv * head_dim, device, bias=bias),
        "wv": dense_init(gen, d_model, n_kv * head_dim, device, bias=bias),
        "wo": dense_init(gen, n_heads * head_dim, d_model, device,
                         scale=0.02 / math.sqrt(2)),
    }


def gqa_apply(
    p: Params,
    x: torch.Tensor,                     # (B, S, d)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    causal: bool = True,
    window: int = 0,
    rope_theta: float = 10_000.0,
    cache: Params | None = None,         # {"k", "v", "len"} for decode
    kv_source: torch.Tensor | None = None,  # (B, N, d) cross-attention context
) -> tuple[torch.Tensor, Params | None]:
    """Self-attention with RoPE, or with ``kv_source`` cross-attention: keys
    and values projected from the context on every call, no rotation,
    attention over the whole context (not causal), nothing cached (the
    cache is not read).  With a cache the new keys and values are
    written into a copy of it (the caller's cache is left as it was), as a
    linear buffer, or as a ring of ``window`` entries when the cache is that
    long.  The ring refuses a multi-token write that would evict a key an
    earlier query of the same write still needs: the JAX package computes
    that case wrongly (ROADMAP, fault 5).

    Under a distribution context with ``model`` above 1
    (``dist.context``) the heads are split over ``model`` as the reference
    pins them there: without a cache, or with ``kv_source``, each rank
    computes its block of :func:`pad_heads_for_tp`'s layout and its rows
    of ``wo``, and the ranks' parts are summed over ``model`` in f32.  With
    a cache that is whole along the sequence, every rank holds (and
    writes) every kv head, attends its block of q slots against the kv
    slots they read, and sums its rows of ``wo`` the same way.  With a
    cache split along the sequence over ``model`` (``seq_shards``), every
    rank computes every head over its positions and the ranks' partial
    softmax sums are merged (:func:`seq_split_attention`); ``wo`` is then
    applied whole, with no sum over ``model``."""
    ctx = dist_context.current()
    split_heads = ctx is not None and ctx.model_size > 1
    if (cache is None or kv_source is not None) and split_heads:
        return _gqa_tp(p, x, ctx, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
                       causal=causal and kv_source is None, window=window,
                       rope_theta=rope_theta, kv_source=kv_source), None
    b, s, _ = x.shape
    q_heads = kv_heads = None
    if cache is not None and split_heads and cache.get("seq_shards", 1) == 1:
        q_heads, kv_heads = tp_heads(n_heads, n_kv, ctx.model_size, ctx.model_coord)
        q = _head_slots(p["wq"], ctx.enter(x), q_heads, head_dim)
    else:
        q = dense_apply(p["wq"], x).reshape(b, s, n_heads, head_dim)
    src = x if kv_source is None else kv_source
    k = dense_apply(p["wk"], src).reshape(b, src.shape[1], n_kv, head_dim)
    v = dense_apply(p["wv"], src).reshape(b, src.shape[1], n_kv, head_dim)

    new_cache = None
    if kv_source is not None:
        out = attention_any(q, k, v, causal=False)
    elif cache is not None:
        out, new_cache = _cached_attention(q, k, v, cache, ctx, kv_heads, causal=causal,
                                           window=window, rope_theta=rope_theta)
    else:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
        out = attention_any(q, k, v, causal=causal, window=window)

    # attention over a higher-precision cache must not promote the residual
    out = out.to(x.dtype)
    if q_heads is not None:
        out = out[:, :, [i for i, h in enumerate(q_heads) if h >= 0]]
        return _wo_rows(p, out, q_heads, ctx, n_heads=n_heads, head_dim=head_dim), new_cache
    y = dense_apply(p["wo"], out.reshape(b, s, n_heads * head_dim))
    return y, new_cache


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache: Params, ctx,
                      kv_heads: list[int] | None, *, causal: bool, window: int,
                      rope_theta: float) -> tuple[torch.Tensor, Params]:
    """``gqa_apply``'s cached path: rotate ``q`` and the new ``k`` at the
    cache's length, write ``k`` and ``v`` into a copy of the cache and
    attend over it.  ``kv_heads`` (the kv slots of a rank's block of the
    padded-TP layout, ``q`` its q slots) selects the cached heads the
    attention reads."""
    s = k.shape[1]
    clen = cache["len"]
    pos = clen + torch.arange(s, device=q.device)
    q = apply_rope(q, pos, rope_theta)
    k = apply_rope(k, pos, rope_theta)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    k = k.to(ck.dtype)
    v = v.to(cv.dtype)
    length = ck.shape[1]
    shards = cache.get("seq_shards", 1)
    new_cache = {"k": ck, "v": cv, "len": clen + s}
    if window > 0 and length * shards == window:
        if shards > 1:
            raise NotImplementedError(f"a ring cache of {window} entries split over model")
        if s > 1 and clen + s > window:
            raise ValueError(
                f"a write of {s} tokens at length {clen} wraps the ring cache of "
                f"{window} entries and evicts keys its own queries need; prefill "
                f"at most {window - clen} tokens at once here"
            )
        idx = (clen + torch.arange(s, device=q.device)) % window
        ck[:, idx] = k
        cv[:, idx] = v
        # unroll the ring chronologically, valid entries first
        valid = min(clen + s, window)
        order = (clen + s - valid + torch.arange(window, device=q.device)) % window
        ka, va = ck[:, order], cv[:, order]
        causal, window, q_offset, kv_len = True, 0, valid - s, valid
    else:
        if clen + s > length * shards:
            raise ValueError(f"the cache holds {length * shards} positions; "
                             f"{clen} + {s} do not fit")
        lo = split_offset(cache, ctx, length)
        write_positions(ck, k, clen, lo)
        write_positions(cv, v, clen, lo)
        if shards > 1:
            out = seq_split_attention(q, ck, cv, ctx, lo=lo, q_offset=clen, kv_len=clen + s,
                                      causal=causal, window=window)
            return out, dict(new_cache, seq_shards=shards)
        ka, va, q_offset, kv_len = ck, cv, clen, clen + s
    if kv_heads is not None:
        ka, va = ka[:, :, kv_heads], va[:, :, kv_heads]
    out = dense_attention(q, ka, va, causal=causal, window=window, q_offset=q_offset,
                          kv_len=kv_len)
    return out, new_cache


def gqa_init_cache(b: int, max_len: int, n_kv: int, head_dim: int, *,
                   window: int = 0, dtype: torch.dtype = torch.bfloat16,
                   device: torch.device | None = None) -> Params:
    """``len`` is a Python int: the host knows every write's position, so
    no step waits on the card to read it."""
    length = window if window > 0 else max_len
    return {
        "k": torch.zeros((b, length, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((b, length, n_kv, head_dim), dtype=dtype, device=device),
        "len": 0,
    }


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu_init(gen, d_model: int, d_ff: int, device: torch.device) -> Params:
    return {
        "wi": dense_init(gen, d_model, d_ff, device),
        "wg": dense_init(gen, d_model, d_ff, device),
        "wo": dense_init(gen, d_ff, d_model, device, scale=0.02 / math.sqrt(2)),
    }


def swiglu_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return dense_apply(p["wo"], F.silu(dense_apply(p["wg"], x)) * dense_apply(p["wi"], x))
