"""Port parity, the attention kernels over their operand's nonzero
columns: the Hopper kernels of ``bsr_attention_fwd`` and
``bsr_attention_bwd_row`` walk A's ``NonzeroColumns``
(``kernels/bsr_spmm.py:nonzero_columns``, the SpMM kernels' operand), and
``bsr_attention_bwd_col`` walks Aᵀ's, one CTA a work item (a block-row,
or one segment of a hub row), a split row's segment partials combined in
slot order by a second pass. ``_fwd_walk``, ``_row_walk`` and
``_col_walk`` model those walks in plain torch, as
``test_torch_nzcols.py:_product`` models the SpMM loop: the forward's
segment partials (acc, m, l) merged by the online-softmax rule, the
column pass's dd taken as z_j·Σ_i w dy_i - Σ_i w r_i (w = att·lrelu'),
as the kernel takes it. Each walk is held against the JAX package's
Pallas kernel in interpret mode (with ``SPLIT_COLUMNS`` set small so that
rows split) and against the port's plain version, for every tile the
SpMM tests sweep, H in {1, 3, 4} with ragged head widths, empty
block-rows and the sampler's padding tail; and the forward on a row
whose max lies in a later segment than its first. ``build_sparse_mha``
builds A's and Aᵀ's columns once, at bind time, for the ``cuda``
executor and never for ``torch``. The kernels themselves run only on the
card: their tests are marked ``cuda`` and skip here.

Tolerances: 1e-4 against Pallas (the JAX suite's attention tolerance:
the walk, the plain version and the interpreter sum in other orders);
1e-5 against the port's plain version (the same float32 terms; the plain
version sums them in float64)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import TILES, nonzero_columns  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    LEAKY_SLOPE,
    NEG_INF,
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
    bsr_spmm_ref,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
PLAIN_TOL = dict(atol=1e-5, rtol=1e-5)
HEADS_DH = [(1, 9), (3, 5), (4, 7)]
#: a split small enough that the graphs' longest rows become segments
SMALL_SPLIT = 3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here so the module collects where
    JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import bsr_attention as jk

    return types.SimpleNamespace(jax=jax, jnp=jnp, k=jk)


def _graph(seed, n_rows=72, n_cols=120, n_edges=170, empty_src=False):
    """A random graph: rows 32..63 without edges (explicit zero blocks at
    br 8 and 16), rows 0..7 a hub (a third of the edges); with
    ``empty_src`` sources 80..95 without edges too (Aᵀ's empty
    block-rows)."""
    r = np.random.default_rng(seed)
    dst = r.integers(0, n_rows, n_edges)
    dst = np.where((dst >= 32) & (dst < 64), dst - 32, dst)
    dst[: n_edges // 3] = r.integers(0, 8, n_edges // 3)
    src = r.integers(0, n_cols, n_edges)
    if empty_src:
        src = np.where((src >= 80) & (src < 96), src - 80, src)
    return csr_from_edges(src, dst, n_rows, n_cols=n_cols)


def _padded(bsr, pad_to=5):
    """The flattened BSR (numpy) with the sampler's zero padding tail, and
    ``last`` (the Pallas forward's finalize flags; the tail's are 0)."""
    arrays = _pad_bsr(bsr, bsr.n_blocks + pad_to)
    arrays["last"] = np.concatenate([bsr.last_in_row, np.zeros(pad_to, np.int32)])
    return arrays


def _stream(seed, br, bc, pad_to=5):
    """``_graph``'s A as a padded stream, with its padded sizes."""
    bsr = csr_to_bsr(_graph(seed), br=br, bc=bc)
    return _padded(bsr, pad_to), bsr.padded_rows, bsr.padded_cols


def _inputs(seed, nrp, ncp, heads, dh):
    r = np.random.default_rng(seed)
    f32 = np.float32
    return dict(adst=r.standard_normal((nrp, heads)).astype(f32),
                asrc=r.standard_normal((ncp, heads)).astype(f32),
                z=r.standard_normal((ncp, heads * dh)).astype(f32),
                dy=r.standard_normal((nrp, heads * dh)).astype(f32),
                r=r.standard_normal((nrp, heads)).astype(f32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _row_walk(nzc, adst, asrc, z, dy, r, m, l, heads):
    """dc as the kernel walks A's nonzero columns: per work item, the sum
    over its columns j and their nonzero rows i of dpre_ij = att_ij
    (dy_i·z_j - r_i) lrelu'(pre_ij) per head; a whole row's sum is its dc,
    a split row's segment sums land in their slots and are added in slot
    order."""
    br, nrb = nzc.br, nzc.n_block_rows
    dh = z.shape[1] // heads
    z3 = z.reshape(-1, heads, dh)
    dy4 = dy.reshape(nrb, br, heads, dh)
    stat = [t.reshape(nrb, br, heads) for t in (adst, r, m, l)]
    dc = torch.zeros((nrb, br, heads))
    partial = torch.zeros((nzc.n_slots, br, heads))
    for row, begin, end, slot in nzc.items.tolist():
        cols = nzc.x_rows[begin:end].long()
        edge = (nzc.values[begin:end] != 0)[..., None]  # [n, br, 1]
        ad, rr, mm, ll = (t[row][None] for t in stat)    # [1, br, H]
        pre = ad + asrc[cols][:, None, :]                # [n, br, H]
        leaky = torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)
        att = torch.exp(leaky - mm) / ll.clamp(min=1e-20)
        dot = torch.einsum("rhd,nhd->nrh", dy4[row], z3[cols])
        dpre = att * (dot - rr) * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)
        part = torch.where(edge, dpre, 0.0).sum(0)
        if slot < 0:
            dc[row] = part
        else:
            partial[slot] = part
    for row, first, n in nzc.splits.tolist():
        dc[row] = partial[first:first + n].sum(0)
    return dc.reshape(nrb * br, heads)


def _leaky(pre):
    return torch.where(pre >= 0, pre, LEAKY_SLOPE * pre)


def _fwd_walk(nzc, adst, asrc, z, heads):
    """(out, m, l) as the forward kernel walks A's nonzero columns: per
    work item, each (row, head)'s exact max over the item's nonzeros, p =
    exp(s - m) on them (0 elsewhere), l = Σ p and acc = Σ p z_j. A whole
    row writes acc / max(l, 1e-20), m (0 where l = 0) and l; a split row's
    segments write (acc, m, l) to their slots, merged in slot order by the
    online-softmax rule, a slot in which a (row, head) has no nonzero
    (l_s = 0) adding nothing."""
    br, nrb = nzc.br, nzc.n_block_rows
    dh = z.shape[1] // heads
    z3 = z.reshape(-1, heads, dh)
    ad = adst.reshape(nrb, br, heads)
    out = torch.zeros((nrb, br, heads, dh))
    m, l = torch.zeros((nrb, br, heads)), torch.zeros((nrb, br, heads))
    slots = {}
    for row, begin, end, slot in nzc.items.tolist():
        cols = nzc.x_rows[begin:end].long()
        edge = (nzc.values[begin:end] != 0)[..., None]  # [n, br, 1]
        s = torch.where(edge, _leaky(ad[row][None] + asrc[cols][:, None, :]), NEG_INF)
        ms = torch.cat([s, torch.full((1, br, heads), NEG_INF)]).amax(0)
        p = torch.where(edge, torch.exp(s - ms), 0.0)
        ls = p.sum(0)
        acc = torch.einsum("nrh,nhd->rhd", p, z3[cols])
        if slot < 0:
            out[row] = acc / ls.clamp(min=1e-20)[..., None]
            m[row], l[row] = torch.where(ls > 0, ms, 0.0), ls
        else:
            slots[slot] = (acc, ms, ls)
    for row, first, n in nzc.splits.tolist():
        parts = [slots[first + k] for k in range(n)]
        mm = torch.stack([torch.where(ls > 0, ms, NEG_INF)
                          for _, ms, ls in parts]).amax(0)
        ll, acc = torch.zeros((br, heads)), torch.zeros((br, heads, dh))
        for a, ms, ls in parts:
            f = torch.where(ls > 0, torch.exp(ms - mm), 0.0)
            ll, acc = ll + ls * f, acc + a * f[..., None]
        out[row] = acc / ll.clamp(min=1e-20)[..., None]
        m[row], l[row] = torch.where(ll > 0, mm, 0.0), ll
    return (out.reshape(nrb * br, heads * dh), m.reshape(-1, heads),
            l.reshape(-1, heads))


def _col_walk(nzc, asrc, adst, z, dy, r, m, l, heads):
    """(dzv, dd) as the column pass walks Aᵀ's nonzero columns (an item's
    rows are sources j, its columns destinations i): per work item, att
    and w = att·lrelu' on the nonzeros, dzv_j = Σ_i att dy_i, and dd_j =
    z_j·Σ_i w dy_i - Σ_i w r_i per head, the kernel's order (the dots
    taken once, after the walk); a split row's segment partials added in
    slot order."""
    br, nrb = nzc.br, nzc.n_block_rows
    dh = z.shape[1] // heads
    z4 = z.reshape(nrb, br, heads, dh)
    dy3 = dy.reshape(-1, heads, dh)
    as3 = asrc.reshape(nrb, br, heads)
    dzv, dd = torch.zeros((nrb, br, heads, dh)), torch.zeros((nrb, br, heads))
    partial = {}
    for row, begin, end, slot in nzc.items.tolist():
        cols = nzc.x_rows[begin:end].long()
        edge = (nzc.values[begin:end] != 0)[..., None]  # [n, br, 1]
        pre = as3[row][None] + adst[cols][:, None, :]    # [n, br, H]
        att = torch.exp(_leaky(pre) - m[cols][:, None, :]) / l[cols][:, None, :].clamp(min=1e-20)
        att = torch.where(edge, att, 0.0)
        w = att * torch.where(pre >= 0, 1.0, LEAKY_SLOPE)
        part_v = torch.einsum("nrh,nhd->rhd", att, dy3[cols])
        g = torch.einsum("nrh,nhd->rhd", w, dy3[cols])
        part_d = (z4[row] * g).sum(-1) - (w * r[cols][:, None, :]).sum(0)
        if slot < 0:
            dzv[row], dd[row] = part_v, part_d
        else:
            partial[slot] = (part_v, part_d)
    for row, first, n in nzc.splits.tolist():
        for k in range(n):
            dzv[row] += partial[first + k][0]
            dd[row] += partial[first + k][1]
    return dzv.reshape(nrb * br, heads * dh), dd.reshape(-1, heads)


def _case(tile, heads, dh, seed=0):
    """A stream, its inputs and the forward's (m, l), all as torch."""
    br, bc = tile
    arrays, nrp, ncp = _stream(seed + br + bc, br, bc)
    t = {k: _t(a) for k, a in arrays.items()}
    v = {k: _t(a) for k, a in _inputs(seed + heads, nrp, ncp, heads, dh).items()}
    _, m, l = bsr_attention_fwd_ref(t["rows"], t["cols"], t["blocks"],
                                    v["adst"], v["asrc"], v["z"], nrp, heads)
    return arrays, t, v, m, l, nrp


def _col_case(tile, heads, dh, seed=0):
    """The column pass's case: Aᵀ of a graph whose sources 80..95 have no
    edge (Aᵀ's empty block-rows), with the padding tail, as a stream; the
    pass's arguments (the destinations' m, l from the plain forward over
    A, random r), all as torch."""
    br, bc = tile
    g = _graph(seed + br + bc, empty_src=True)
    a, at = csr_to_bsr(g, br=br, bc=bc), csr_to_bsr(g.transpose(), br=br, bc=bc)
    arrays = _padded(at)
    t = {k: _t(x) for k, x in arrays.items()}
    nr, nc, ntr, ntc = a.padded_rows, a.padded_cols, at.padded_rows, at.padded_cols
    v = {k: _t(x) for k, x in _inputs(seed + heads, nr, nc, heads, dh).items()}
    _, m, l = bsr_attention_fwd_ref(*(_t(x) for x in (a.block_rows, a.block_cols,
                                                      a.blocks)),
                                    v["adst"], v["asrc"], v["z"], nr, heads)
    fit = tops._fit_rows
    args = (t["rows"], t["cols"], t["blocks"], fit(v["asrc"], ntr),
            fit(v["adst"], ntc), fit(v["z"], ntr), fit(v["dy"], ntc),
            fit(v["r"], ntc), fit(m, ntc), fit(l, ntc), ntr, heads)
    return arrays, tuple(x.contiguous() if isinstance(x, torch.Tensor) else x
                         for x in args)


IDS = dict(heads=[f"H{h}xDh{d}" for h, d in HEADS_DH],
           tile=[f"{r}x{c}" for r, c in TILES])


@pytest.mark.parametrize("heads,dh", HEADS_DH, ids=IDS["heads"])
@pytest.mark.parametrize("tile", TILES, ids=IDS["tile"])
def test_fwd_walk_matches_pallas_with_split_rows(jx, monkeypatch, tile, heads, dh):
    """The forward's walk over A's columns, hub rows split into segments
    of ``SMALL_SPLIT`` columns and merged, against the Pallas forward in
    interpret mode and the port's plain version (which the wrapper runs
    on the CPU, and which takes the same value with ``nzc=``)."""
    arrays, t, v, _, _, nrp = _case(tile, heads, dh)
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", SMALL_SPLIT)
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
    assert nzc.splits.shape[0] > 0  # the hub rows split
    walk = _fwd_walk(nzc, v["adst"], v["asrc"], v["z"], heads)
    args = (t["rows"], t["cols"], t["blocks"], v["adst"], v["asrc"], v["z"], nrp, heads)
    plain = bsr_attention_fwd_ref(*args)
    wrapped = bsr_attention_fwd(*args, nzc=nzc)
    j = jx.jnp.asarray
    pallas = jx.k.bsr_attention_fwd(
        *(j(arrays[k]) for k in ("rows", "cols", "first", "last", "blocks")),
        *(j(v[k].numpy()) for k in ("adst", "asrc", "z")),
        n_rows_padded=nrp, heads=heads, dh=dh, interpret=True)
    for w, p, q, x in zip(walk, plain, wrapped, pallas):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **PLAIN_TOL)
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(w.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("heads,dh", HEADS_DH, ids=IDS["heads"])
@pytest.mark.parametrize("tile", TILES, ids=IDS["tile"])
def test_col_walk_matches_pallas_with_split_rows(jx, monkeypatch, tile, heads, dh):
    """The column pass's walk over Aᵀ's columns, rows split into segments
    of ``SMALL_SPLIT`` columns, against the Pallas column pass in
    interpret mode and the port's plain version."""
    arrays, args = _col_case(tile, heads, dh)
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", SMALL_SPLIT)
    nzc = nonzero_columns(*args[:3], args[-2])
    assert nzc.splits.shape[0] > 0
    walk = _col_walk(nzc, *args[3:10], heads)
    plain = bsr_attention_bwd_col_ref(*args)
    wrapped = bsr_attention_bwd_col(*args, nzc=nzc)
    j = jx.jnp.asarray
    pallas = jx.k.bsr_attention_bwd_col(
        *(j(arrays[k]) for k in ("rows", "cols", "first", "blocks")),
        *(j(a.numpy()) for a in args[3:10]),
        n_rows_padded=args[-2], heads=heads, dh=dh, interpret=True)
    for w, p, q, x in zip(walk, plain, wrapped, pallas):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **PLAIN_TOL)
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(w.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("split", [SMALL_SPLIT, 1024])
@pytest.mark.parametrize("tile", TILES, ids=IDS["tile"])
def test_fwd_and_col_walks_give_zero_on_empty_rows_and_ignore_padding(
        monkeypatch, tile, split):
    """Block-rows without an edge (A's rows 32..63, Aᵀ's sources 80..95:
    explicit zero blocks) get out = m = l = 0 and dzv = dd = 0 from an
    empty work item; the padding tail adds no column; both walks equal
    the plain versions with and without split rows."""
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
    _, t, v, _, _, nrp = _case(tile, 3, 5, seed=1)
    base = (t["rows"], t["cols"], t["blocks"])
    nzc = nonzero_columns(*base, nrp)
    no_tail = nonzero_columns(*(x[:-5] for x in base), nrp)
    assert torch.equal(nzc.x_rows, no_tail.x_rows)
    walk = _fwd_walk(nzc, v["adst"], v["asrc"], v["z"], 3)
    empty = (nzc.columns_per_row() == 0).repeat_interleave(nzc.br)
    assert empty[32:64].all()
    for x in walk:
        assert torch.equal(x[empty], torch.zeros_like(x[empty]))
    plain = bsr_attention_fwd_ref(*base, v["adst"], v["asrc"], v["z"], nrp, 3)
    for w, p in zip(walk, plain):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **PLAIN_TOL)
    _, args = _col_case(tile, 3, 5, seed=1)
    nzc = nonzero_columns(*args[:3], args[-2])
    assert torch.equal(nzc.x_rows, nonzero_columns(*(x[:-5] for x in args[:3]),
                                                   args[-2]).x_rows)
    walk = _col_walk(nzc, *args[3:10], 3)
    empty = (nzc.columns_per_row() == 0).repeat_interleave(nzc.br)
    assert empty[80:96].all()
    for x in walk:
        assert torch.equal(x[empty], torch.zeros_like(x[empty]))
    for w, p in zip(walk, bsr_attention_bwd_col_ref(*args)):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **PLAIN_TOL)


def _late_max_case():
    """One 8x8 block-row over 24 source columns, 9 of them nonzero (three
    segments at ``SMALL_SPLIT``): row 0's scores rise along the row, so
    its max lies in the last segment; row 1 holds nonzeros only in the
    last segment, so its first two segments carry m = NEG_INF, l = 0 and
    must add nothing; rows 2..7 none. Returns the numpy stream (padding
    tail included), adst, asrc, z and the max row 0 must get."""
    blocks = np.zeros((3, 8, 8), np.float32)
    blocks[0, 0, [1, 4, 6]] = 1.0
    blocks[1, 0, [0, 3, 7]] = 1.0
    blocks[2, 0, [2, 5, 6]] = 1.0
    blocks[2, 1, [2, 5, 6]] = 1.0
    arrays = {"rows": np.zeros(5, np.int32), "cols": np.array([0, 1, 2, 0, 0], np.int32),
              "first": np.array([1, 0, 0, 0, 0], np.int32),
              "last": np.array([0, 0, 1, 0, 0], np.int32),
              "blocks": np.concatenate([blocks, np.zeros((2, 8, 8), np.float32)])}
    asrc = np.linspace(-2.0, 5.0, 24, dtype=np.float32)[:, None]
    adst = np.full((8, 1), 0.3, np.float32)
    z = np.random.default_rng(4).standard_normal((24, 3)).astype(np.float32)
    return arrays, adst, asrc, z, float(0.3 + asrc[16 + 6, 0])


def test_fwd_walk_merges_a_max_in_a_later_segment(jx, monkeypatch):
    """A row split into three segments whose max lies in the last, and a
    row whose first two segments hold none of its nonzeros: the walk's
    merged (out, m, l) against the plain version and the Pallas forward,
    and row 0's max exactly."""
    arrays, adst, asrc, z, row0_max = _late_max_case()
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", SMALL_SPLIT)
    t = {k: _t(x) for k, x in arrays.items()}
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], 8)
    assert nzc.splits.tolist() == [[0, 0, 3]]
    walk = _fwd_walk(nzc, _t(adst), _t(asrc), _t(z), 1)
    assert float(walk[1][0, 0]) == pytest.approx(row0_max, abs=1e-6)
    plain = bsr_attention_fwd_ref(t["rows"], t["cols"], t["blocks"], _t(adst),
                                  _t(asrc), _t(z), 8, 1)
    j = jx.jnp.asarray
    pallas = jx.k.bsr_attention_fwd(
        *(j(arrays[k]) for k in ("rows", "cols", "first", "last", "blocks")),
        j(adst), j(asrc), j(z), n_rows_padded=8, heads=1, dh=3, interpret=True)
    for w, p, x in zip(walk, plain, pallas):
        np.testing.assert_allclose(w.numpy(), p.numpy(), **PLAIN_TOL)
        np.testing.assert_allclose(w.numpy(), np.asarray(x), **TOL)


@pytest.mark.parametrize("heads,dh", HEADS_DH, ids=IDS["heads"])
@pytest.mark.parametrize("tile", TILES, ids=IDS["tile"])
def test_row_walk_matches_pallas_with_split_rows(jx, monkeypatch, tile, heads, dh):
    """The walk over A's columns, hub rows split into segments of
    ``SMALL_SPLIT`` columns, against the Pallas row pass in interpret mode
    and the port's plain version (which the wrapper runs on the CPU, and
    which takes the same value with ``nzc=``)."""
    arrays, t, v, m, l, nrp = _case(tile, heads, dh)
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", SMALL_SPLIT)
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
    assert nzc.splits.shape[0] > 0  # the hub rows split
    args = (v["adst"], v["asrc"], v["z"], v["dy"], v["r"], m, l)
    walk = _row_walk(nzc, *args, heads)
    base = (t["rows"], t["cols"], t["blocks"])
    plain = bsr_attention_bwd_row_ref(*base, *args, nrp, heads)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), **PLAIN_TOL)
    wrapped = bsr_attention_bwd_row(*base, *args, nrp, heads, nzc=nzc)
    np.testing.assert_allclose(wrapped.numpy(), plain.numpy(), rtol=0, atol=0)
    j = jx.jnp.asarray
    pallas = jx.k.bsr_attention_bwd_row(
        j(arrays["rows"]), j(arrays["cols"]), j(arrays["first"]),
        j(arrays["blocks"]), *(j(a.numpy()) for a in args),
        n_rows_padded=nrp, heads=heads, dh=dh, interpret=True)
    np.testing.assert_allclose(walk.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("split", [SMALL_SPLIT, 1024])
@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_row_walk_gives_zero_on_empty_rows_and_ignores_padding(monkeypatch, tile, split):
    """Block-rows without an edge (rows 32..63, explicit zero blocks) get
    dc = 0 from an empty work item; the padding tail adds no column; the
    walk equals the plain version with and without split rows."""
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
    _, t, v, m, l, nrp = _case(tile, 3, 5, seed=1)
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
    nzc_no_tail = nonzero_columns(*(x[:-5] for x in (t["rows"], t["cols"],
                                                     t["blocks"])), nrp)
    assert torch.equal(nzc.x_rows, nzc_no_tail.x_rows)
    args = (v["adst"], v["asrc"], v["z"], v["dy"], v["r"], m, l)
    walk = _row_walk(nzc, *args, 3)
    per_row = nzc.columns_per_row()
    empty = (per_row == 0).repeat_interleave(nzc.br)
    assert empty[32:64].all()
    assert torch.equal(walk[empty], torch.zeros_like(walk[empty]))
    plain = bsr_attention_bwd_row_ref(t["rows"], t["cols"], t["blocks"], *args,
                                      nrp, 3)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), **PLAIN_TOL)


def _count_builds(monkeypatch) -> list:
    built = []
    real = tops.nonzero_columns

    def counted(block_rows, block_cols, blocks, n_rows_padded):
        built.append(n_rows_padded)
        return real(block_rows, block_cols, blocks, n_rows_padded)

    monkeypatch.setattr(tops, "nonzero_columns", counted)
    return built


@pytest.mark.parametrize("inner", ["cuda", "torch"])
def test_build_sparse_mha_builds_a_columns_once_at_bind_time(monkeypatch, inner):
    """``build_sparse_mha`` builds A's nonzero columns (the forward and the
    row pass read them) and Aᵀ's (the column pass) when it is bound on the
    ``cuda`` executor (device cpu), and the forward and backward calls
    build no more. The ``torch`` executor builds none. Both give the same
    gradients."""
    built = _count_builds(monkeypatch)
    r = np.random.default_rng(5)
    g = csr_from_edges(r.integers(0, 40, 160), r.integers(0, 40, 160), 40)
    fwd, bwd = tops.build_bsr_pair(g, br=8, bc=16, device="cpu")
    mha = tops.build_sparse_mha(fwd, bwd, inner)
    cuda = inner == "cuda"
    assert len(built) == 2 * int(cuda)
    assert (fwd.nzc is not None) == cuda and (bwd.nzc is not None) == cuda
    columns = (fwd.nzc, bwd.nzc)
    z = torch.from_numpy(r.standard_normal((40, 3, 5)).astype(np.float32))
    a_src, a_dst = (torch.from_numpy(r.standard_normal((3, 5)).astype(np.float32))
                    for _ in range(2))
    grads = []
    for _ in range(2):
        zt, st, dt = (x.clone().requires_grad_(True) for x in (z, a_src, a_dst))
        mha(zt, st, dt).square().sum().backward()
        grads.append((zt.grad, st.grad, dt.grad))
    assert len(built) == 2 * int(cuda) and (fwd.nzc, bwd.nzc) == columns
    ref = tops.build_sparse_mha(fwd, bwd, "torch")
    zt, st, dt = (x.clone().requires_grad_(True) for x in (z, a_src, a_dst))
    ref(zt, st, dt).square().sum().backward()
    for got, want in zip(grads[0], (zt.grad, st.grad, dt.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_columns_of_another_operand_are_refused():
    """``nzc=`` must be the operand's own columns (its block-rows and
    height), on every device; a CPU call without it runs the plain
    version."""
    arrays, nrp, ncp = _stream(3, 8, 16)
    t = {k: _t(a) for k, a in arrays.items()}
    v = {k: _t(a) for k, a in _inputs(3, nrp, ncp, 2, 3).items()}
    m, l = torch.zeros((nrp, 2)), torch.ones((nrp, 2))
    args = (t["rows"], t["cols"], t["blocks"], v["adst"], v["asrc"], v["z"],
            v["dy"], v["r"], m, l, nrp, 2)
    other = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp + 8)
    with pytest.raises(ValueError, match="block-rows"):
        bsr_attention_bwd_row(*args, nzc=other)
    before = bsr_attention_bwd_row.launches
    torch.testing.assert_close(bsr_attention_bwd_row(*args),
                               bsr_attention_bwd_row_ref(*args), rtol=0, atol=0)
    assert bsr_attention_bwd_row.launches == before


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper does with a
    card's tensor before its first CUDA call, on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["fwd", "row", "col"])
def test_cuda_call_without_nzc_raises(kind):
    """A CUDA call of each pass reads its operand's nonzero columns and
    never builds them itself: without ``nzc`` it raises before launching
    anything, and no path falls back to the plain version."""
    _, t, v, m, l, nrp = _case((8, 16), 2, 3)
    base = (t["rows"], t["cols"], t["blocks"])
    fn, args = {
        "fwd": (bsr_attention_fwd, (*base, v["adst"], v["asrc"], v["z"], nrp, 2)),
        "row": (bsr_attention_bwd_row, (*base, v["adst"], v["asrc"], v["z"],
                                        v["dy"], v["r"], m, l, nrp, 2)),
        "col": (bsr_attention_bwd_col, _col_case((8, 16), 2, 3)[1])}[kind]
    args = tuple(x.as_subclass(_OnCard) if isinstance(x, torch.Tensor) else x
                 for x in args)
    assert args[5].device.type == "cuda"
    launches = fn.launches
    with pytest.raises(ValueError, match="needs nzc="):
        fn(*args)
    assert fn.launches == launches


@pytest.mark.cuda
def test_cuda_plain_versions_are_bitwise_repeatable():
    """On the card: the plain SpMM and the three plain attention passes
    sum each row in stream order (``kernels/ref.py:_row_add``), so two
    calls are bitwise equal, on a graph whose hub rows take hundreds of
    blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = np.random.default_rng(9)
    n = 3000
    dst = np.concatenate([r.integers(0, n, 40000), r.integers(0, 8, 8000)])
    src = r.integers(0, n, dst.size)
    g = csr_from_edges(src, dst, n)
    for tile in ((8, 16), (16, 64)):
        a = csr_to_bsr(g, br=tile[0], bc=tile[1])
        base = tuple(_t(x).cuda() for x in (a.block_rows, a.block_cols, a.blocks))
        nr, nc = a.padded_rows, a.padded_cols
        v = {k: _t(x).cuda() for k, x in _inputs(3, nr, nc, 3, 20).items()}
        x = torch.randn((nc, 64), generator=torch.Generator().manual_seed(1)).cuda()
        fargs = (*base, v["adst"], v["asrc"], v["z"], nr, 3)
        _, m, l = bsr_attention_fwd_ref(*fargs)
        rargs = (*base, v["adst"], v["asrc"], v["z"], v["dy"], v["r"], m, l, nr, 3)
        # the same stream read as Aᵀ: sources on its rows, destinations on
        # its columns
        fit = tops._fit_rows
        cargs = (*base, fit(v["adst"], nr), fit(v["asrc"], nc), fit(v["dy"], nr),
                 fit(v["z"], nc), fit(v["r"], nc), fit(m, nc), fit(l, nc) + 1.0,
                 nr, 3)
        for name, fn, args in (("spmm", bsr_spmm_ref, (*base, x, nr)),
                               ("fwd", bsr_attention_fwd_ref, fargs),
                               ("row", bsr_attention_bwd_row_ref, rargs),
                               ("col", bsr_attention_bwd_col_ref, cargs)):
            got, again = fn(*args), fn(*args)
            got, again = ((y,) if isinstance(y, torch.Tensor) else y for y in (got, again))
            assert all(torch.equal(p, q) for p, q in zip(got, again)), (name, tile)


def _cuda_args(args):
    return tuple(x.cuda() if isinstance(x, torch.Tensor) else x for x in args)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [SMALL_SPLIT, 1024])
def test_cuda_forward_and_column_pass_match_plain_on_split_and_unsplit_rows(
        monkeypatch, split):
    """On the card: the forward over A's nonzero columns and the column
    pass over Aᵀ's against their plain versions at 1e-4 on every tile, H
    in {1, 3, 4} with ragged head widths and a wide one (3 x 250), empty
    block-rows and the padding tail, rows split (``SPLIT_COLUMNS`` 3) and
    whole; the late-max row; a repeat launch bitwise equal; one launch a
    call; a call without ``nzc`` raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
    cases = [(tile, h, d) for tile in TILES for h, d in HEADS_DH]
    cases += [((8, 128), 3, 250), ((16, 64), 3, 250)]
    arrays, adst, asrc, z, row0_max = _late_max_case()
    late = (*(_t(arrays[k]) for k in ("rows", "cols", "blocks")), _t(adst),
            _t(asrc), _t(z), 8, 1)
    runs = [("fwd", bsr_attention_fwd, bsr_attention_fwd_ref, _cuda_args(late))]
    for tile, heads, dh in cases:
        _, t, v, _, _, nrp = _case(tile, heads, dh, seed=7)
        fargs = (t["rows"], t["cols"], t["blocks"], v["adst"], v["asrc"], v["z"],
                 nrp, heads)
        runs.append(("fwd", bsr_attention_fwd, bsr_attention_fwd_ref,
                     _cuda_args(fargs)))
        runs.append(("col", bsr_attention_bwd_col, bsr_attention_bwd_col_ref,
                     _cuda_args(_col_case(tile, heads, dh, seed=7)[1])))
    for kind, fn, ref, args in runs:
        nzc = nonzero_columns(*args[:3], args[-2])
        assert (nzc.splits.shape[0] > 0) == (split == SMALL_SPLIT), kind
        before = fn.launches
        got, again, want = fn(*args, nzc=nzc), fn(*args, nzc=nzc), ref(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        label = f"{kind} {tuple(args[2].shape)} H={args[-1]}"
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b), label
            np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **TOL,
                                       err_msg=label)
        with pytest.raises(ValueError, match="nzc="):
            fn(*args)
    if split == SMALL_SPLIT:
        _, m, _ = bsr_attention_fwd(*runs[0][3], nzc=nonzero_columns(
            *runs[0][3][:3], 8))
        assert float(m[0, 0]) == pytest.approx(row0_max, abs=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [SMALL_SPLIT, 1024])
def test_cuda_row_pass_matches_plain_on_split_and_unsplit_rows(monkeypatch, split):
    """On the card: the row pass over A's nonzero columns against its plain
    version at 1e-4 on every tile, H in {1, 3, 4} with ragged head widths
    and a wide one (3 x 250), empty block-rows and the padding tail, rows
    split (``SPLIT_COLUMNS`` 3) and whole; a repeat launch bitwise equal;
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
    cases = [(tile, h, d) for tile in TILES for h, d in HEADS_DH]
    cases += [((8, 128), 3, 250), ((16, 64), 3, 250)]
    for tile, heads, dh in cases:
        _, t, v, m, l, nrp = _case(tile, heads, dh, seed=7)
        t = {k: x.cuda() for k, x in t.items()}
        args = (t["rows"], t["cols"], t["blocks"],
                *(x.cuda() for x in (v["adst"], v["asrc"], v["z"], v["dy"], v["r"],
                                     m, l)), nrp, heads)
        nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
        assert (nzc.splits.shape[0] > 0) == (split == SMALL_SPLIT)
        before = bsr_attention_bwd_row.launches
        got = bsr_attention_bwd_row(*args, nzc=nzc)
        again = bsr_attention_bwd_row(*args, nzc=nzc)
        want = bsr_attention_bwd_row_ref(*args)
        torch.cuda.synchronize()
        assert bsr_attention_bwd_row.launches == before + 2
        assert torch.equal(got, again), (tile, heads, dh)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL,
                                   err_msg=f"{tile} H={heads} Dh={dh}")
        with pytest.raises(ValueError, match="nzc="):
            bsr_attention_bwd_row(*args)
