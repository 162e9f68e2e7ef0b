"""Port parity, the nonzero-column operand of the three SpMM kernels
(``kernels/bsr_spmm.py:nonzero_columns``): its entries scatter back
to the blocks exactly, come in stream order, and skip every column that
holds no nonzero (the sampler's padding tail, an empty block-row's zero
block, the zero columns inside a block); its work list covers every
block-row once, longest first, a long row as fixed segments with their
partial-sum slots; a product over it, segment partials added in order,
equals the BSR product; and that walk, and the fused pair that builds the
operand once, match the JAX package's Pallas kernels in interpret mode,
forward and VJP, for every built tile; so do ``bsr_spmm`` with its
operand and the walk over it, against the Pallas ``bsr_spmm``. Every
binding builds each operand's columns once, when it is bound; the
``torch`` executor builds none. The non-finite rule: an X row that no
nonzero multiplies is never read, so the walk gives the JAX ``gather``
backend's finite answer where the Pallas kernel gives NaN. The kernels
that read the operand run only on the card (``cuda``-marked tests here
and in ``test_torch_fused_epilogue.py`` and ``test_torch_bsr_spmm.py``).

Tolerances: exact for the operand itself (a copy of the blocks' values);
1e-5 for a product over it against the BSR plain version (the same
products summed in another order, O(10) terms of unit size); 1e-4 against
the Pallas kernels, the SpMM and fused-epilogue tolerance of the JAX
suite, and for the kernels against the walk on the card."""
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.graph.csr import csr_from_dense, csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    TILES,
    _vec4,
    bsr_spmm,
    bsr_spmm_fused_epilogue,
    bsr_spmm_masked,
    nonzero_columns,
)
from repro_torch.kernels.ref import (  # noqa: E402
    bsr_spmm_fused_ref,
    bsr_spmm_masked_ref,
    bsr_spmm_ref,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here so the module collects where
    JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.backends import get_backend as jax_backend
    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.kernels import ops
    from repro.kernels.bsr_spmm import bsr_spmm as pallas_bsr_spmm

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops,
                                 csr_from_edges=jax_csr_from_edges,
                                 bsr_spmm=pallas_bsr_spmm, backend=jax_backend)


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
        # products summed elementwise, so 0·inf gives NaN as in IEEE
        part = (nzc.values[cols][:, :, None]
                * x[nzc.x_rows[cols].long()][:, None, :]).sum(0)
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


@pytest.mark.parametrize("f", [1, 13, 40, 256])
@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
def test_bsr_spmm_with_its_columns_matches_pallas(jx, tile, f):
    """``bsr_spmm`` given its operand's columns (the plain version on the
    CPU) and the walk over them that its kernel makes, split rows and all,
    match the Pallas ``bsr_spmm`` in interpret mode and ``bsr_spmm_ref``
    within 1e-4: empty block-rows, the padding tail, F from 1 to 256."""
    br, bc = tile
    rows, cols, blocks, nrp, ncp = _stream(7 * br + bc + f, br, bc)
    x = torch.from_numpy(np.random.default_rng(f).standard_normal(
        (ncp, f)).astype(np.float32))
    j = [jx.jnp.asarray(t.numpy()) for t in (rows, cols, blocks)]
    first = jx.jnp.asarray(np.r_[1, (rows[1:] != rows[:-1]).numpy()].astype(np.int32))
    want = np.asarray(jx.bsr_spmm(j[0], j[1], first, j[2], jx.jnp.asarray(x.numpy()),
                                  n_rows_padded=nrp, bf=f, interpret=True))
    np.testing.assert_allclose(bsr_spmm_ref(rows, cols, blocks, x, nrp).numpy(),
                               want, **TOL)
    nzc = nonzero_columns(rows, cols, blocks, nrp)
    y = bsr_spmm(rows, cols, blocks, x, nrp, nzc=nzc)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bsr_spmm_module, "SPLIT_COLUMNS", 3)
        split = nonzero_columns(rows, cols, blocks, nrp)
    assert split.n_slots > 0
    for op in (nzc, split):
        np.testing.assert_allclose(_product(op, x, nrp).numpy(), want, **TOL)


def _count_builds(monkeypatch) -> list:
    """Record every ``nonzero_columns`` build that the bindings make."""
    built = []
    real = tops.nonzero_columns

    def counted(block_rows, block_cols, blocks, n_rows_padded):
        built.append(n_rows_padded)
        return real(block_rows, block_cols, blocks, n_rows_padded)

    monkeypatch.setattr(tops, "nonzero_columns", counted)
    return built


@pytest.mark.parametrize("inner", ["cuda", "torch"])
def test_every_binding_builds_each_operands_columns_once(monkeypatch, inner):
    """``BSRDevice.matmul`` (at its first call, kept), the backend's
    ``feature_matmul_sparse`` over X and Xᵀ and ``build_fused_epilogue``
    over A and Aᵀ (both when they are bound, before any call) build each
    operand's nonzero columns exactly once on the ``cuda`` executor
    (device cpu); forward and backward calls build no more, and the
    operands' bytes count them. The ``torch`` executor builds none."""
    cuda = inner == "cuda"
    built = _count_builds(monkeypatch)
    r = np.random.default_rng(3)
    g = csr_from_edges(r.integers(0, 40, 150), r.integers(0, 40, 150), 40,
                       data=r.standard_normal(150).astype(np.float32))
    fwd, bwd = tops.build_bsr_pair(g, br=8, bc=16, device="cpu")
    x = torch.from_numpy(r.standard_normal((40, 6)).astype(np.float32))
    for _ in range(2):
        fwd.matmul(x, inner)
    assert len(built) == int(cuda) and (fwd.nzc is not None) == cuda

    built.clear()
    fused = tops.build_fused_epilogue(fwd, bwd, inner)
    assert len(built) == int(cuda)  # A's were built by matmul, and kept
    u = x.clone().requires_grad_(True)
    fused(u, bias=torch.ones(6)).sum().backward()
    fused(u, activation="relu").sum().backward()
    assert len(built) == int(cuda) and (bwd.nzc is not None) == cuda

    built.clear()
    feats = r.random((40, 30)).astype(np.float32)
    feats[feats < 0.8] = 0.0
    mm = get_backend(inner).feature_matmul_sparse(feats, br=8, device="cpu")
    assert len(built) == 2 * int(cuda)
    w = torch.from_numpy(r.standard_normal((30, 5)).astype(np.float32))
    w.requires_grad_(True)
    y = mm(w)
    y.sum().backward()
    mm(w).sum().backward()
    assert len(built) == 2 * int(cuda)
    np.testing.assert_allclose(y.detach().numpy(), feats @ w.detach().numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy() / 2, feats.T @ np.ones((40, 5)),
                               atol=1e-4, rtol=1e-5)
    x_op = get_backend(inner).build_spmm_operand(csr_from_dense(feats), br=8,
                                                 device="cpu")
    blocks_only = x_op.nbytes
    assert get_backend(inner).operand_bytes(x_op) == blocks_only
    if cuda:
        x_op.nonzero_columns()
        assert x_op.nbytes == blocks_only + x_op.nzc.nbytes


def _non_finite_case():
    """A 16x16 graph at 8x8 tiles: (0, 0) 2, (1, 1) 3, (9, 2) 1.5, (10,
    12) -0.5 (dst, src): blocks (0, 0), (1, 0) and (1, 1) are stored. X
    rows 3 and 5 (inf, NaN) lie in block column 0 and row 14 (-inf) in
    block column 1, where every stored value is 0: no nonzero multiplies
    them. Row 12, which (10, 12) multiplies, is finite."""
    src, dst = np.array([0, 1, 2, 12]), np.array([0, 1, 9, 10])
    data = np.array([2.0, 3.0, 1.5, -0.5], np.float32)
    x = np.random.default_rng(0).standard_normal((16, 4)).astype(np.float32)
    x[3], x[5], x[14] = np.inf, np.nan, -np.inf
    want = np.zeros((16, 4), np.float32)
    for s_, d_, v in zip(src, dst, data):
        want[d_] += v * x[s_]
    return src, dst, data, x, want


def test_non_finite_x_gives_the_gather_answer_not_the_pallas_one(jx):
    """The JAX package disagrees with itself on an X row holding inf or
    NaN that no nonzero multiplies: its ``gather`` backend (a segment sum
    over the edges) gives the finite sparse product, its Pallas
    ``bsr_spmm`` in interpret mode NaN on every row of the block-rows
    whose stored blocks cover the row (0·inf). The port's kernels give
    the ``gather`` answer: the walk over the nonzero columns never reads
    such a row. The port's plain version multiplies whole blocks, as the
    Pallas kernel does."""
    src, dst, data, x, want = _non_finite_case()
    jg = jx.csr_from_edges(src, dst, 16, n_cols=16, data=data)
    gather = jx.backend("gather")
    y_gather = np.asarray(gather.spmm(gather.build_spmm_operand(jg), jx.jnp.asarray(x)))
    np.testing.assert_allclose(y_gather, want, atol=1e-6)
    assert np.isfinite(y_gather).all()

    g = csr_from_edges(src, dst, 16, n_cols=16, data=data)
    bsr = csr_to_bsr(g, br=8, bc=8)
    assert bsr.n_blocks == 3
    t = {k: torch.from_numpy(v) for k, v in
         (("rows", bsr.block_rows), ("cols", bsr.block_cols), ("blocks", bsr.blocks))}
    y_pallas = np.asarray(jx.bsr_spmm(
        *(jx.jnp.asarray(a) for a in (bsr.block_rows, bsr.block_cols,
                                      bsr.first_in_row, bsr.blocks)),
        jx.jnp.asarray(x), n_rows_padded=16, bf=4, interpret=True))
    assert np.isnan(y_pallas).all()  # both block-rows' blocks cover rows 3 and 5
    xt = torch.from_numpy(x)
    assert torch.isnan(bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], xt, 16)).all()

    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], 16)
    assert sorted(nzc.x_rows.tolist()) == [0, 1, 2, 12]
    walk = _product(nzc, xt, 16)
    np.testing.assert_allclose(walk.numpy(), y_gather, atol=1e-6)


def _non_finite_rows(rows, cols, blocks, nrp):
    """The X rows inside a stored block's columns that no nonzero
    multiplies, and those that one does."""
    _, br, bc = blocks.shape
    covered = (cols.long()[:, None] * bc + torch.arange(bc)).flatten()
    read = set(nonzero_columns(rows, cols, blocks, nrp).x_rows.tolist())
    unread = sorted(set(covered.tolist()) - read)
    return unread, sorted(read)


def _fully_read_row(cols, blocks):
    """An X row that a nonzero multiplies in every stored block whose
    columns cover it, so the kernels (over the nonzero columns) and the
    plain versions (over whole blocks) read it alike; None if no row is."""
    _, br, bc = blocks.shape
    covered = (cols.long()[:, None] * bc + torch.arange(bc)).flatten()
    held = (blocks != 0).any(dim=1).flatten()
    partly = set(covered[~held].tolist())
    rows = sorted(set(covered[held].tolist()) - partly)
    return rows[0] if rows else None


@pytest.mark.cuda
def test_cuda_kernels_give_the_gather_answer_under_non_finite_x():
    """On the card: ``bsr_spmm``, ``bsr_spmm_fused_epilogue`` (bias +
    ReLU) and ``bsr_spmm_masked`` with inf, -inf and NaN in X rows that
    no nonzero multiplies give the sparse product (the JAX ``gather``
    backend's answer, ``test_non_finite_x_gives_the_gather_answer_not_the_pallas_one``):
    finite, within 1e-4 of the walk over the columns, where the plain
    versions (whole blocks, as Pallas) give NaN. With an inf in a row
    that a nonzero multiplies too, every kernel's non-finite entries are
    the walk's, the fused kernel's without an activation and with its
    ReLU, which keeps a NaN as ``torch.relu`` and ``jnp.maximum`` do
    (the no-activation epilogue gives the pre-activation's -inf and NaN
    as they are); and with that read row alone non-finite, the fused
    kernel with its ReLU equals the plain version (NaN where it gives
    NaN), for each tile and both vector widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    src, dst, data, x, want = _non_finite_case()
    cases = [(csr_to_bsr(csr_from_edges(src, dst, 16, n_cols=16, data=data),
                         br=8, bc=8), x, 4)]
    for (br, bc), f in itertools.product(TILES, (36, 37)):
        r = np.random.default_rng(br * bc + f)
        g = csr_from_edges(r.integers(0, 130, 200), r.integers(0, 150, 200), 150,
                           n_cols=130, data=r.standard_normal(200).astype(np.float32))
        cases.append((csr_to_bsr(g, br=br, bc=bc),
                      r.standard_normal((-(-130 // bc) * bc, f)).astype(np.float32), f))
    against_plain = 0
    for case, (bsr, x_np, f) in enumerate(cases):
        t = {k: torch.from_numpy(v).cuda() for k, v in
             (("rows", bsr.block_rows), ("cols", bsr.block_cols), ("blocks", bsr.blocks))}
        nrp = bsr.padded_rows
        nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
        cpu = {k: v.cpu() for k, v in t.items()}
        walk_nzc = nonzero_columns(cpu["rows"], cpu["cols"], cpu["blocks"], nrp)
        unread, read = _non_finite_rows(cpu["rows"], cpu["cols"], cpu["blocks"], nrp)
        assert unread
        x = torch.from_numpy(x_np).clone()
        bad = torch.tensor([np.inf, -np.inf, np.nan])
        for i, row in enumerate(unread):
            x[row] = bad[i % 3]
        mask = (torch.arange(x.numel()).reshape(x.shape) % 3 > 0).float()
        b = torch.linspace(-1, 1, f)
        for with_read in (False, True):
            if with_read:
                x[read[0]] = np.inf
            xc, mc, bc_ = x.cuda(), mask.cuda(), b.cuda()
            args = (t["rows"], t["cols"], t["blocks"], xc, nrp)
            pre = _product(walk_nzc, x, nrp) + b
            got = {
                "bsr_spmm": (bsr_spmm(*args, nzc=nzc), _product(walk_nzc, x, nrp)),
                "fused": (bsr_spmm_fused_epilogue(*args, bias=bc_, activation="relu",
                                                  nzc=nzc)[0], torch.relu(pre)),
                "fused, no activation": (bsr_spmm_fused_epilogue(
                    *args, bias=bc_, activation="none", nzc=nzc)[0], pre),
                "masked": (bsr_spmm_masked(t["rows"], t["cols"], t["blocks"], xc, mc,
                                           nrp, nzc=nzc),
                           _product(walk_nzc, x * mask, nrp)),
            }
            torch.cuda.synchronize()
            for name, (y, walk) in got.items():
                if not with_read:
                    assert torch.isfinite(y).all(), (case, name)
                torch.testing.assert_close(y.cpu(), walk, atol=1e-4, rtol=1e-4,
                                           equal_nan=True, msg=f"{case} {name}")
            if not with_read:
                plain = (bsr_spmm_ref(*args), bsr_spmm_fused_ref(*args, bias=bc_,
                                                                 activation="none")[0],
                         bsr_spmm_masked_ref(*args[:4], mc, nrp))
                assert all(not torch.isfinite(p).all() for p in plain), case
        # a read row alone non-finite: the fused ReLU keeps the NaN the
        # plain version (and Pallas) give, and its mask is 0 there
        row = _fully_read_row(cpu["cols"], cpu["blocks"])
        if row is None:
            continue
        against_plain += 1
        x_read = torch.from_numpy(np.where(np.isfinite(x_np), x_np, 0.0)
                                  .astype(np.float32))
        x_read[row] = np.inf
        args = (t["rows"], t["cols"], t["blocks"], x_read.cuda(), nrp)
        y, y_mask = bsr_spmm_fused_epilogue(*args, bias=b.cuda(), activation="relu",
                                            nzc=nzc)
        want, _ = bsr_spmm_fused_ref(*args, bias=b.cuda(), activation="relu")
        torch.cuda.synchronize()
        assert torch.isnan(want).any(), case
        torch.testing.assert_close(y, want, atol=1e-4, rtol=1e-4, equal_nan=True,
                                   msg=f"{case} fused ReLU, a read row non-finite")
        assert torch.equal(y_mask[torch.isnan(want)],
                           torch.zeros_like(y_mask[torch.isnan(want)])), case
    assert against_plain >= 1  # the first case's row 12
