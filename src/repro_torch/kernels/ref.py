"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel is held against
on the card, and the executor for CPU tensors (the tests, and the
``torch`` reference backend on any device). Counterpart of
``repro/kernels/ref.py``.

The SpMM and attention versions walk the block stream in fixed chunks of
about ``CHUNK_BYTES`` of gathered operand, in stream order, each chunk
added into the output: a full-graph operand gathered in one piece
(ogbn-arxiv's A at F=256: ~120 GB) would not fit on the card.

A chunk's terms reach the output rows through ``_row_add``: a segment sum
per block-row in stream order, then one add per row. ``index_add_`` of
the terms themselves would add them atomically on the card, in an order
that changes from run to run. So these versions give the same bits on
every run, on the CPU and on the card.

The attention versions add each block's float32 partial sums into float64
row sums: the score cotangents (dc, dd) are sums that nearly cancel, and
with float32 row sums in a varying order the GAT path's a_dst gradient
read 1.3e-3 away from the kernels' (H100, ``chip_smoke.py``'s training
check), more than its 1e-3 gate allows.
"""
from __future__ import annotations

import torch

#: gathered operand per chunk of the plain SpMM versions
CHUNK_BYTES = 1 << 30


def _row_add(out: torch.Tensor, rows: torch.Tensor, terms: torch.Tensor) -> None:
    """``out[rows[k]] += terms[k]`` for one chunk of the block stream, its
    rows sorted (the stream contract): each row's terms summed in stream
    order (``torch.segment_reduce``), then added once per row, so no two
    adds meet and the result does not depend on the device's scheduling.
    On unsorted rows it still sums right, in no fixed order."""
    rows_u, counts = torch.unique_consecutive(rows, return_counts=True)
    out.index_add_(0, rows_u, torch.segment_reduce(terms, "sum", lengths=counts,
                                                   axis=0))


def bsr_spmm_ref(
    block_rows: torch.Tensor,  # [n_blocks] int (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int
    blocks: torch.Tensor,  # [n_blocks, BR, BC]
    x: torch.Tensor,  # [n_cols_padded, F]
    n_rows_padded: int,
) -> torch.Tensor:
    """Y[r*BR:(r+1)*BR] += blocks[b] @ X[c*BC:(c+1)*BC] for each block b.

    Float32 [n_rows_padded, F]; block-rows without blocks are zero.
    Bitwise repeatable on every device (``_row_add``)."""
    n_blocks, br, bc = blocks.shape
    f = x.shape[-1]
    x_blk = x.float().reshape(x.shape[0] // bc, bc, f)
    out = torch.zeros((n_rows_padded // br, br, f), dtype=torch.float32,
                      device=x.device)
    step = max(1, CHUNK_BYTES // max(4 * bc * f, 1))
    for s in range(0, n_blocks, step):
        gathered = x_blk[block_cols[s:s + step].long()]  # [chunk, BC, F]
        prod = torch.bmm(blocks[s:s + step].float(), gathered)
        _row_add(out, block_rows[s:s + step].long(), prod)
    return out.reshape(n_rows_padded, f)


def bsr_spmm_accum_ref(
    out: torch.Tensor,  # [n_rows_padded, F] float32: what y holds
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,
    n_rows_padded: int,
) -> torch.Tensor:
    """``out + A·X``: the plain version of ``bsr_spmm``'s accumulate mode
    (a host-streamed strip's product added to the strips before it). A
    new tensor; ``out`` is not changed."""
    return out + bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)


def bsr_spmm_fused_ref(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,
    n_rows_padded: int,
    self_term: "torch.Tensor | None" = None,  # [n_rows_padded, F]
    bias: "torch.Tensor | None" = None,  # [F]
    alpha=None,  # scalar or 1-element tensor; 1.0 when None
    activation: str = "none",
):
    """act(A @ X + alpha * self_term + bias), the epilogue composed after
    the SpMM. Returns ``(y, mask)`` for relu (mask float32 0/1 of the
    pre-activation's sign), else ``(y, None)``."""
    z = bsr_spmm_ref(block_rows, block_cols, blocks, x, n_rows_padded)
    if self_term is not None:
        a = 1.0 if alpha is None else alpha
        z = z + a * self_term.float()
    if bias is not None:
        z = z + bias.float().reshape(1, -1)
    if activation == "relu":
        return torch.relu(z), (z > 0).float()
    if activation != "none":
        raise ValueError(f"unsupported fused activation {activation!r}")
    return z, None


def bsr_spmm_masked_ref(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    x: torch.Tensor,  # [n_cols_padded, F] — the incoming cotangent
    mask: torch.Tensor,  # shaped like x — the saved activation mask
    n_rows_padded: int,
) -> torch.Tensor:
    """Y = A @ (mask ⊙ X): the fused-epilogue VJP through a ReLU."""
    return bsr_spmm_ref(block_rows, block_cols, blocks, x * mask,
                        n_rows_padded)


def fused_adam_ref(p, g, m, v, lr_t: float, beta1: float, beta2: float,
                   eps: float, weight_decay: float):
    """One AdamW step in float32; ``lr_t`` already folds the bias
    correction: lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t). Returns
    ``(p, m, v)``."""
    g = g.float()
    p32 = p.float()
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * g * g
    update = m_new / (torch.sqrt(v_new) + eps) + weight_decay * p32
    return (p32 - lr_t * update).to(p.dtype), m_new, v_new


# ---------------------------------------------------------------------------
# Edge-softmax attention over the BSR nonzero pattern (DESIGN.md §10)
# ---------------------------------------------------------------------------

NEG_INF = -1e30
LEAKY_SLOPE = 0.2


def _leaky(pre: torch.Tensor) -> torch.Tensor:
    return torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)


def _attn_step(block_bytes: int) -> int:
    """Blocks per chunk of the plain attention versions."""
    return max(1, CHUNK_BYTES // max(block_bytes, 1))


def bsr_attention_fwd_ref(
    block_rows: torch.Tensor,  # [n_blocks] int (sorted)
    block_cols: torch.Tensor,  # [n_blocks] int
    blocks: torch.Tensor,  # [n_blocks, BR, BC]; nonzero pattern = adjacency
    adst: torch.Tensor,  # [n_rows_padded, H] a_dst·z_i
    asrc: torch.Tensor,  # [n_cols_padded, H] a_src·z_j
    z: torch.Tensor,  # [n_cols_padded, H*Dh] head-major source features
    n_rows_padded: int,
    heads: int,
):
    """Edge softmax over each row's nonzeros, then the weighted aggregate:
    ``out_i = Σ_j softmax_j(leaky_relu(adst_i + asrc_j, 0.2)) z_j`` per
    head. Returns ``(out [n_rows_padded, H*Dh], m, l [n_rows_padded, H])``,
    (m, l) the rows' softmax max and denominator, m clamped to 0 where a
    row has no nonzero (the kernel's finalize step).

    Counterpart of ``repro/kernels/ref.py:bsr_attention_ref``. Two chunked
    walks of the stream: the first takes each row's true max
    (``scatter_reduce_`` amax), the second sums ``p = exp(s - m)`` and
    ``p·z`` against it. Zero blocks (padding, empty rows) contribute
    nothing."""
    n_blocks, br, bc = blocks.shape
    h = heads
    hd = z.shape[-1]
    dh = hd // h
    nrb = n_rows_padded // br
    dev = z.device
    ad_blk = adst.float().reshape(nrb, br, h)
    as_blk = asrc.float().reshape(-1, bc, h)
    z_blk = z.float().reshape(-1, bc, h, dh)
    step = _attn_step(4 * bc * hd)

    def scores(s0):
        rows = block_rows[s0:s0 + step].long()
        cols = block_cols[s0:s0 + step].long()
        mask = (blocks[s0:s0 + step] != 0)[..., None]  # [c, BR, BC, 1]
        pre = ad_blk[rows][:, :, None, :] + as_blk[cols][:, None, :, :]
        return rows, cols, mask, torch.where(mask, _leaky(pre), NEG_INF)

    m = torch.full((nrb, br, h), NEG_INF, dtype=torch.float32, device=dev)
    for s0 in range(0, n_blocks, step):
        rows, _, _, s = scores(s0)
        mb = s.amax(dim=2).reshape(rows.shape[0], br * h)
        m.view(nrb, br * h).scatter_reduce_(
            0, rows[:, None].expand_as(mb), mb, "amax")
    l = torch.zeros((nrb, br, h), dtype=torch.float64, device=dev)
    acc = torch.zeros((nrb, br, h, dh), dtype=torch.float64, device=dev)
    for s0 in range(0, n_blocks, step):
        rows, cols, mask, s = scores(s0)
        p = torch.where(mask, torch.exp(s - m[rows][:, :, None, :]), 0.0)
        _row_add(l, rows, p.sum(dim=2).double())
        # [c, H, BR, BC] @ [c, H, BC, Dh] -> [c, BR, H, Dh]
        pz = torch.matmul(p.permute(0, 3, 1, 2), z_blk[cols].permute(0, 2, 1, 3))
        _row_add(acc, rows, pz.permute(0, 2, 1, 3).double())
    l = l.float().reshape(n_rows_padded, h)
    m = torch.where(l > 0, m.reshape(n_rows_padded, h), 0.0)
    out = acc.float().reshape(n_rows_padded, h, dh) / l.clamp(min=1e-20)[..., None]
    return out.reshape(n_rows_padded, hd), m, l


def _attn_weights(pre, mask, m, l):
    """att = exp(leaky_relu(pre) - m) / max(l, 1e-20) on the nonzeros, the
    softmax weights recomputed from the saved row statistics; 0 elsewhere."""
    att = torch.exp(_leaky(pre) - m) / l.clamp(min=1e-20)
    return torch.where(mask, att, 0.0)


def bsr_attention_bwd_row_ref(
    block_rows: torch.Tensor,
    block_cols: torch.Tensor,
    blocks: torch.Tensor,
    adst: torch.Tensor,  # [n_rows_padded, H]
    asrc: torch.Tensor,  # [n_cols_padded, H]
    z: torch.Tensor,  # [n_cols_padded, H*Dh]
    dy: torch.Tensor,  # [n_rows_padded, H*Dh] cotangent of out
    r: torch.Tensor,  # [n_rows_padded, H] = Σ_d dy·out
    m: torch.Tensor,  # [n_rows_padded, H] saved row max
    l: torch.Tensor,  # [n_rows_padded, H] saved row denominator
    n_rows_padded: int,
    heads: int,
) -> torch.Tensor:
    """The recompute backward's row pass over A: ``dc_i = Σ_j dpre_ij`` with
    ``dpre_ij = att_ij (dy_i·z_j - r_i) leaky_relu'(pre_ij)`` per head,
    [n_rows_padded, H] (the destination-side score cotangent)."""
    n_blocks, br, bc = blocks.shape
    h = heads
    hd = z.shape[-1]
    dh = hd // h
    nrb = n_rows_padded // br
    row_stat = [t.float().reshape(nrb, br, h) for t in (adst, r, m, l)]
    as_blk = asrc.float().reshape(-1, bc, h)
    z_blk = z.float().reshape(-1, bc, h, dh)
    dy_blk = dy.float().reshape(nrb, br, h, dh)
    dc = torch.zeros((nrb, br, h), dtype=torch.float64, device=z.device)
    step = _attn_step(4 * bc * hd)
    for s0 in range(0, n_blocks, step):
        rows = block_rows[s0:s0 + step].long()
        cols = block_cols[s0:s0 + step].long()
        mask = (blocks[s0:s0 + step] != 0)[..., None]
        ad, rr, mm, ll = (t[rows][:, :, None, :] for t in row_stat)
        pre = ad + as_blk[cols][:, None, :, :]  # [c, BR, BC, H]
        att = _attn_weights(pre, mask, mm, ll)
        # [c, H, BR, Dh] @ [c, H, Dh, BC] -> [c, BR, BC, H]
        datt = torch.matmul(dy_blk[rows].permute(0, 2, 1, 3),
                            z_blk[cols].permute(0, 2, 3, 1)).permute(0, 2, 3, 1)
        dpre = att * (datt - rr) * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)
        _row_add(dc, rows, dpre.sum(dim=2).double())
    return dc.float().reshape(n_rows_padded, h)


def bsr_attention_bwd_col_ref(
    block_rows: torch.Tensor,  # Aᵀ: tile rows are sources j
    block_cols: torch.Tensor,  # Aᵀ: tile columns are destinations i
    blocks: torch.Tensor,
    asrc: torch.Tensor,  # [n_rows_padded, H] source side
    adst: torch.Tensor,  # [n_cols_padded, H] destination side
    z: torch.Tensor,  # [n_rows_padded, H*Dh] source side
    dy: torch.Tensor,  # [n_cols_padded, H*Dh] destination side
    r: torch.Tensor,  # [n_cols_padded, H]
    m: torch.Tensor,  # [n_cols_padded, H]
    l: torch.Tensor,  # [n_cols_padded, H]
    n_rows_padded: int,
    heads: int,
):
    """The recompute backward's column pass over Aᵀ, per source j:
    ``dzv_j = Σ_i att_ij dy_i`` and ``dd_j = Σ_i dpre_ij``. Operands
    indexed by the block rows live on the source side (asrc, z), those
    indexed by the block columns on the destination side (adst, dy, r, m,
    l). Returns ``(dzv [n_rows_padded, H*Dh], dd [n_rows_padded, H])``."""
    n_blocks, br, bc = blocks.shape
    h = heads
    hd = z.shape[-1]
    dh = hd // h
    nrb = n_rows_padded // br
    as_blk = asrc.float().reshape(nrb, br, h)
    z_blk = z.float().reshape(nrb, br, h, dh)
    col_stat = [t.float().reshape(-1, bc, h) for t in (adst, r, m, l)]
    dy_blk = dy.float().reshape(-1, bc, h, dh)
    dzv = torch.zeros((nrb, br, h, dh), dtype=torch.float64, device=z.device)
    dd = torch.zeros((nrb, br, h), dtype=torch.float64, device=z.device)
    step = _attn_step(4 * bc * hd)
    for s0 in range(0, n_blocks, step):
        rows = block_rows[s0:s0 + step].long()
        cols = block_cols[s0:s0 + step].long()
        mask = (blocks[s0:s0 + step] != 0)[..., None]  # [c, BR(j), BC(i), 1]
        ad, rr, mm, ll = (t[cols][:, None, :, :] for t in col_stat)
        pre = as_blk[rows][:, :, None, :] + ad  # [c, BR, BC, H]
        att = _attn_weights(pre, mask, mm, ll)
        dyc = dy_blk[cols].permute(0, 2, 1, 3)  # [c, H, BC, Dh]
        # [c, H, BR, Dh] @ [c, H, Dh, BC] -> [c, BR, BC, H]
        datt = torch.matmul(z_blk[rows].permute(0, 2, 1, 3),
                            dyc.transpose(2, 3)).permute(0, 2, 3, 1)
        dpre = att * (datt - rr) * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)
        _row_add(dd, rows, dpre.sum(dim=2).double())
        # [c, H, BR, BC] @ [c, H, BC, Dh] -> [c, BR, H, Dh]
        _row_add(dzv, rows, torch.matmul(att.permute(0, 3, 1, 2),
                                         dyc).permute(0, 2, 1, 3).double())
    return (dzv.float().reshape(n_rows_padded, hd),
            dd.float().reshape(n_rows_padded, h))


#: masked logit of the flash attention kernel (``repro/kernels/flash_attention.py``)
FLASH_NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, Hkv, Tk, D]
    v: torch.Tensor,  # [B, Hkv, Tk, D]
    causal: bool = True,
    sm_scale: "float | None" = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v as the Pallas kernel computes it: float32
    logits times ``1/sqrt(D)``, ``-1e30`` where ``col > row`` if causal
    (the mask aligned top-left: query row i sees keys 0..i whatever Tk is),
    a float32 softmax and product with float32 v, the output in q's dtype.

    Query head h reads KV head ``h // (H // Hkv)`` (the LM's grouped
    query attention); ``Hkv == H`` is the JAX kernel's contract. Not the
    JAX package's ``flash_attention_ref``, which aligns the causal mask
    bottom-right and agrees with the kernel only where Tq == Tk."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{hkv} KV heads do not divide {h} query heads")
    scale = sm_scale if sm_scale is not None else 1.0 / float(d) ** 0.5
    qg = q.float().reshape(b, hkv, h // hkv, tq, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        above = torch.ones((tq, tk), dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(above, FLASH_NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", probs, v.float())
    return out.reshape(b, h, tq, d).to(q.dtype)
