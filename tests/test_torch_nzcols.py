"""Port parity, the nonzero-column operand of the fused-epilogue and masked
kernels (``kernels/bsr_spmm.py:nonzero_columns``): its entries scatter back
to the blocks exactly, come in stream order, and skip every column that
holds no nonzero (the sampler's padding tail, an empty block-row's zero
block, the zero columns inside a block); its work list covers every
block-row once, longest first, a long row as fixed segments with their
partial-sum slots; a product over it, segment partials added in order,
equals the BSR product; and that walk, and the fused pair that builds the
operand once, match the JAX package's Pallas kernels in interpret mode,
forward and VJP, for every built tile. The kernels that read it run only
on the card (``test_torch_fused_epilogue.py``'s ``cuda`` test).

Tolerances: exact for the operand itself (a copy of the blocks' values);
1e-5 for a product over it against the BSR plain version (the same
products summed in another order, O(10) terms of unit size); 1e-4 against
the Pallas kernels, the fused-epilogue tolerance of the JAX suite."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    TILES,
    _vec4,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
    nonzero_columns,
)
from repro_torch.kernels.ref import bsr_spmm_ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here so the module collects where
    JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.kernels import ops

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops,
                                 csr_from_edges=jax_csr_from_edges)


def _stream(seed, br, bc, n_rows=90, n_cols=140, n_edges=220, pad_to=6):
    """A random graph's flattened BSR as torch tensors, with explicit zero
    blocks on its empty block-rows (rows 40..55 have no edges) and the
    sampler's zero padding tail; also its padded sizes."""
    r = np.random.default_rng(seed)
    dst = r.integers(0, n_rows, n_edges)
    dst = np.where((dst >= 40) & (dst < 56), dst - 30, dst)
    src = r.integers(0, n_cols, n_edges)
    g = csr_from_edges(src, dst, n_rows, n_cols=n_cols,
                       data=r.standard_normal(n_edges).astype(np.float32))
    bsr = csr_to_bsr(g, br=br, bc=bc)
    arrays = _pad_bsr(bsr, bsr.n_blocks + pad_to)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return t["rows"], t["cols"], t["blocks"], bsr.padded_rows, bsr.padded_cols


def _entries_by_loop(rows, cols, blocks, n_rows_padded):
    """The operand written as plain loops: (block-row, X row, values) of
    every column holding a nonzero, in stream order."""
    _, br, bc = blocks.shape
    out = []
    for b in range(blocks.shape[0]):
        for k in range(bc):
            col = blocks[b, :, k]
            if bool((col != 0).any()):
                out.append((int(rows[b]), int(cols[b]) * bc + k, col.clone()))
    return out


def _row_ptr(nzc):
    """Each block-row's start in the column stream, and the end."""
    return torch.cat([torch.zeros(1, dtype=torch.int64),
                      nzc.columns_per_row().cumsum(0)])


def _product(nzc, x, nrp):
    """Y = A·X over the operand as the kernels walk it: each item's
    columns summed; a whole row's sum is its output, a split row's
    segment sums land in their slots and are added in slot order."""
    br, f = nzc.br, x.shape[1]
    y = torch.zeros((nrp // br, br, f))
    partial = torch.zeros((nzc.n_slots, br, f))
    for row, begin, end, slot in nzc.items.tolist():
        cols = slice(begin, end)
        part = torch.einsum("nr,nf->rf", nzc.values[cols],
                            x[nzc.x_rows[cols].long()])
        if slot < 0:
            y[row] = part
        else:
            partial[slot] = part
    for row, first, n in nzc.splits.tolist():
        y[row] = partial[first:first + n].sum(0)
    return y.reshape(nrp, f)


@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_entries_scatter_back_to_the_blocks(tile):
    """Scattering every entry to its (row, X row) gives the dense operand
    the blocks give, exactly, and each entry's values are its column."""
    br, bc = tile
    rows, cols, blocks, nrp, ncp = _stream(br + bc, br, bc)
    nzc = nonzero_columns(rows, cols, blocks, nrp)
    dense = torch.zeros((nrp, ncp))
    for b in range(blocks.shape[0]):
        r0, c0 = int(rows[b]) * br, int(cols[b]) * bc
        dense[r0:r0 + br, c0:c0 + bc] += blocks[b]
    back = torch.zeros((nrp, ncp))
    brow = torch.repeat_interleave(torch.arange(nrp // br), nzc.columns_per_row())
    for e in range(nzc.x_rows.numel()):
        r0 = int(brow[e]) * br
        back[r0:r0 + br, int(nzc.x_rows[e])] = nzc.values[e]
    assert torch.equal(back, dense)
    assert nzc.values.dtype == torch.float32 and nzc.values.shape[1] == br
    assert nzc.values.is_contiguous() and nzc.values.data_ptr() % 16 == 0
    assert nzc.items.data_ptr() % 16 == 0 and nzc.n_block_rows == nrp // br


@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_entries_come_in_stream_order(tile):
    """Block, then column within it: the loop-built list entry by entry;
    each block-row's X rows strictly increase; with no row past the split,
    ``items`` holds each block-row's span once (slot -1), longest first,
    ties by block-row."""
    br, bc = tile
    rows, cols, blocks, nrp, _ = _stream(3 * br + bc, br, bc)
    nzc = nonzero_columns(rows, cols, blocks, nrp)
    want = _entries_by_loop(rows, cols, blocks, nrp)
    assert nzc.x_rows.tolist() == [x for _, x, _ in want]
    assert torch.equal(nzc.values, torch.stack([v for _, _, v in want]))
    spans = nzc.columns_per_row()
    assert spans.tolist() == np.bincount([r for r, _, _ in want],
                                         minlength=nrp // br).tolist()
    ptr = _row_ptr(nzc)
    for r in range(nrp // br):
        xs = nzc.x_rows[ptr[r]:ptr[r + 1]]
        assert bool((xs[1:] > xs[:-1]).all())
    items = nzc.items.tolist()
    assert sorted(r for r, *_ in items) == list(range(nrp // br))
    assert all(b == ptr[r] and e == ptr[r + 1] and s == -1 for r, b, e, s in items)
    keys = [(b - e, r) for r, b, e, _ in items]
    assert keys == sorted(keys)
    assert nzc.splits.shape == (0, 3) and nzc.n_slots == 0
    assert nzc.items.dtype == nzc.splits.dtype == nzc.x_rows.dtype == torch.int32


def test_padding_empty_rows_and_zero_columns_give_no_entries():
    """Rows 0-1 hold (0, 0), (0, 5) and (1, 5): one 8x8 block whose
    columns 1-4, 6, 7 are zero, and an explicit 0.0 in column 0's row 1;
    block-rows 1 and 2 are empty (an explicit zero block each); the
    sampler pads the stream with 4 zero blocks. Two entries come out."""
    g = csr_from_edges(np.array([0, 5, 5]), np.array([0, 0, 1]), 24, n_cols=8,
                       data=np.array([2.0, 3.0, 4.0], np.float32))
    bsr = csr_to_bsr(g, br=8, bc=8)
    assert bsr.n_blocks == 3  # row 0's block, and rows 1 and 2's zero blocks
    arrays = _pad_bsr(bsr, bsr.n_blocks + 4)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    assert t["blocks"].shape[0] == 7
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], bsr.padded_rows)
    assert nzc.items.tolist() == [[0, 0, 2, -1], [1, 2, 2, -1], [2, 2, 2, -1]]
    assert nzc.x_rows.tolist() == [0, 5]
    want = torch.zeros((2, 8))
    want[0, 0], want[1, 0], want[1, 1] = 2.0, 3.0, 4.0
    assert torch.equal(nzc.values, want)
    assert nzc.nbytes == 4 * (12 + 2 + 16)


@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_product_over_the_columns_matches_the_bsr_product(tile):
    """Y = A·(M ⊙ X) summed over the entries (one X row and br values
    each) equals the plain BSR product, padding tail and all."""
    br, bc = tile
    rows, cols, blocks, nrp, ncp = _stream(5 * br + bc, br, bc)
    r = np.random.default_rng(bc)
    x = torch.from_numpy(r.standard_normal((ncp, 21)).astype(np.float32))
    m = torch.from_numpy((r.random((ncp, 21)) < 0.6).astype(np.float32))
    want = bsr_spmm_ref(rows, cols, blocks, x * m, nrp)
    for split in (1024, 3):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
            nzc = nonzero_columns(rows, cols, blocks, nrp)
        assert (nzc.n_slots > 0) == (split == 3)
        torch.testing.assert_close(_product(nzc, x * m, nrp), want,
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("split", [1, 4, 7, 1000])
def test_rows_past_the_split_become_ordered_segments(monkeypatch, split):
    """A row of more than ``SPLIT_COLUMNS`` columns is cut into segments of
    that many (the last one shorter) that tile its span in order, with
    consecutive slots starting at its ``splits`` entry; every other row is
    one item with slot -1; the items run longest first."""
    rows, cols, blocks, nrp, _ = _stream(11, 8, 32, n_edges=400)
    monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
    nzc = nonzero_columns(rows, cols, blocks, nrp)
    ptr, counts = _row_ptr(nzc), nzc.columns_per_row()
    by_row = {}
    for row, begin, end, slot in nzc.items.tolist():
        by_row.setdefault(row, []).append((slot, begin, end))
    assert sorted(by_row) == list(range(nrp // 8))
    first = {row: (f, n) for row, f, n in nzc.splits.tolist()}
    assert sorted(first) == [r for r in range(nrp // 8) if counts[r] > split]
    slots = []
    for row, segs in by_row.items():
        segs.sort()
        if row not in first:
            assert segs == [(-1, ptr[row], ptr[row + 1])]
            continue
        f, n = first[row]
        assert [s for s, _, _ in segs] == list(range(f, f + n))
        assert [b for _, b, _ in segs] == list(range(ptr[row], ptr[row + 1], split))
        assert all(e - b == min(split, ptr[row + 1] - b) for _, b, e in segs)
        slots += [s for s, _, _ in segs]
    assert sorted(slots) == list(range(nzc.n_slots))
    lengths = [e - b for _, b, e, _ in nzc.items.tolist()]
    assert lengths == sorted(lengths, reverse=True)


def _pairs(jx, n, br, bc, seed):
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, n, 4 * n), r.integers(0, n, 4 * n)
    data = r.standard_normal(4 * n).astype(np.float32)
    g = csr_from_edges(src, dst, n, n_cols=n, data=data)
    jg = jx.csr_from_edges(src, dst, n, n_cols=n, data=data)
    return (tops.build_bsr_pair(g, br=br, bc=bc, device="cpu"),
            jx.ops.build_bsr_pair(jg, br=br, bc=bc))


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_fused_pair_builds_the_columns_once_and_matches_pallas(jx, tile, act):
    """``build_fused_epilogue(..., "cuda")`` builds A's and Aᵀ's nonzero
    columns once (the operands' bytes count them; calls reuse them). The
    walk over them that the kernels make (``_product``: A's columns, the
    epilogue after it, forward; Aᵀ's columns over the masked cotangent,
    the VJP) matches the JAX package's fused pair on its Pallas kernels in
    interpret mode at 1e-4, and so does the pair itself. 75 nodes: the
    paddings of A and Aᵀ differ for most tiles."""
    br, bc = tile
    (fwd, bwd), (jf, jb) = _pairs(jx, 75, br, bc, seed=br * bc)
    blocks_only = fwd.nbytes
    fused = tops.build_fused_epilogue(fwd, bwd, "cuda")
    built = (fwd.nzc, bwd.nzc)
    assert built[0] is not None and built[1] is not None
    assert fwd.nbytes == blocks_only + fwd.nzc.nbytes
    r = np.random.default_rng(bc + (act == "relu"))
    f = 12
    u = r.standard_normal((75, f)).astype(np.float32)
    b = r.standard_normal(f).astype(np.float32)
    dy = r.standard_normal((75, f)).astype(np.float32)

    jfused = jx.ops.build_fused_epilogue(jf, jb, "pallas", interpret=True)
    y_j, vjp = jx.jax.vjp(lambda u_, b_: jfused(u_, bias=b_, activation=act),
                          jx.jnp.asarray(u), jx.jnp.asarray(b))
    du_j, db_j = vjp(jx.jnp.asarray(dy))

    ut, bt = (torch.from_numpy(a).requires_grad_(True) for a in (u, b))
    y = fused(ut, bias=bt, activation=act)
    y.backward(torch.from_numpy(dy))
    assert (fwd.nzc, bwd.nzc) == built and fwd.nzc is built[0]

    pre = _product(fwd.nzc, tops._fit_rows(torch.from_numpy(u), fwd.n_cols_padded),
                   fwd.n_rows_padded)[:75] + torch.from_numpy(b)
    walk_y = torch.relu(pre) if act == "relu" else pre
    g = torch.from_numpy(dy) * (pre > 0).float() if act == "relu" else torch.from_numpy(dy)
    t_in = -(-fwd.n_rows_padded // bwd.bc) * bwd.bc
    walk_du = _product(bwd.nzc, tops._fit_rows(g, t_in), bwd.n_rows_padded)[:75]
    for got, want in ((walk_y, y_j), (walk_du, du_j), (y.detach(), y_j),
                      (ut.grad, du_j), (bt.grad, db_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_torch_executor_builds_no_columns():
    """The ``torch`` executor (the plain versions) needs no operand."""
    g = csr_from_edges(np.arange(20) % 7, np.arange(20) % 9, 9, n_cols=7,
                       data=np.ones(20, np.float32))
    fwd, bwd = tops.build_bsr_pair(g, br=8, bc=8, device="cpu")
    tops.build_fused_epilogue(fwd, bwd, "torch")
    assert fwd.nzc is None and bwd.nzc is None
    assert fwd.nonzero_columns() is fwd.nonzero_columns()


def test_wrappers_check_the_columns_they_are_given():
    rows, cols, blocks, nrp, ncp = _stream(1, 8, 16)
    x = torch.zeros((ncp, 4))
    nzc = nonzero_columns(rows, cols, blocks, nrp)
    other = nonzero_columns(rows, cols, blocks, nrp + 8)
    assert other.n_block_rows == nzc.n_block_rows + 1
    with pytest.raises(ValueError, match="block-rows"):
        bsr_spmm_fused_epilogue(rows, cols, blocks, x, nrp, nzc=other)
    with pytest.raises(ValueError, match="block-rows"):
        bsr_spmm_masked(rows, cols, blocks, x, x, nrp, nzc=other)
    shifted = dataclasses.replace(
        nzc, values=torch.empty(nzc.values.numel() + 1)[1:].view(nzc.values.shape))
    with pytest.raises(ValueError, match="16-byte aligned"):
        bsr_spmm_masked(rows, cols, blocks, x, x, nrp, nzc=shifted)
    with pytest.raises(ValueError, match="past n_rows_padded"):
        nonzero_columns(rows, cols, blocks, nrp - 8)
    y, _ = bsr_spmm_fused_epilogue(rows, cols, blocks, x, nrp, nzc=nzc)
    assert y.shape == (nrp, 4)


def test_vec4_needs_f_a_multiple_of_4_and_aligned_rows():
    """The float4 path: F % 4 == 0 and every feature operand 16-byte
    aligned (a view one float in is not); absent operands do not count."""
    x = torch.zeros((10, 8))
    assert _vec4(8, x, None)
    assert not _vec4(6, torch.zeros((10, 6)))
    shifted = torch.zeros(81)[1:].view(10, 8)
    assert shifted.is_contiguous() and not _vec4(8, x, shifted)
