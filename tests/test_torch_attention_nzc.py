"""Port parity, the attention row pass over A's nonzero columns: the
Hopper kernel of ``bsr_attention_bwd_row`` walks A's ``NonzeroColumns``
(``kernels/bsr_spmm.py:nonzero_columns``, the SpMM kernels' operand), one
CTA a work item (a block-row, or one segment of a hub row), a split row's
segment partials added in slot order by a second pass. ``_row_walk``
models that walk in plain torch, as ``test_torch_nzcols.py:_product``
models the SpMM loop; here it is held against the JAX package's Pallas
``bsr_attention_bwd_row`` in interpret mode (with ``SPLIT_COLUMNS`` set
small so that rows split) and against the port's plain version, for
every tile the SpMM tests sweep, H in {1, 3, 4} with ragged head widths,
empty block-rows and the sampler's padding tail. ``build_sparse_mha``
builds A's columns once, at bind time, for the ``cuda`` executor and
never for ``torch``. The kernel itself runs only on the card: its test
is marked ``cuda`` and skips here.

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
from repro_torch.kernels.bsr_attention import bsr_attention_bwd_row  # noqa: E402
from repro_torch.kernels.bsr_spmm import TILES, nonzero_columns  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    LEAKY_SLOPE,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
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


def _stream(seed, br, bc, n_rows=72, n_cols=120, n_edges=170, pad_to=5):
    """A random graph's flattened BSR (numpy), rows 32..63 without edges
    (explicit zero blocks at br 8 and 16), rows 0..7 a hub (a third of the
    edges),
    and the sampler's zero padding tail; with its padded sizes."""
    r = np.random.default_rng(seed)
    dst = r.integers(0, n_rows, n_edges)
    dst = np.where((dst >= 32) & (dst < 64), dst - 32, dst)
    dst[: n_edges // 3] = r.integers(0, 8, n_edges // 3)
    src = r.integers(0, n_cols, n_edges)
    g = csr_from_edges(src, dst, n_rows, n_cols=n_cols)
    bsr = csr_to_bsr(g, br=br, bc=bc)
    return _pad_bsr(bsr, bsr.n_blocks + pad_to), bsr.padded_rows, bsr.padded_cols


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


def _case(tile, heads, dh, seed=0):
    """A stream, its inputs and the forward's (m, l), all as torch."""
    br, bc = tile
    arrays, nrp, ncp = _stream(seed + br + bc, br, bc)
    t = {k: _t(a) for k, a in arrays.items()}
    v = {k: _t(a) for k, a in _inputs(seed + heads, nrp, ncp, heads, dh).items()}
    _, m, l = bsr_attention_fwd_ref(t["rows"], t["cols"], t["blocks"],
                                    v["adst"], v["asrc"], v["z"], nrp, heads)
    return arrays, t, v, m, l, nrp


@pytest.mark.parametrize("heads,dh", HEADS_DH, ids=[f"H{h}xDh{d}" for h, d in HEADS_DH])
@pytest.mark.parametrize("tile", TILES, ids=[f"{r}x{c}" for r, c in TILES])
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
    """``build_sparse_mha`` builds A's nonzero columns when it is bound on
    the ``cuda`` executor (device cpu), and the forward and backward calls
    build no more; Aᵀ's are not built (the column pass reads its blocks).
    The ``torch`` executor builds none. Both give the same gradients."""
    built = _count_builds(monkeypatch)
    r = np.random.default_rng(5)
    g = csr_from_edges(r.integers(0, 40, 160), r.integers(0, 40, 160), 40)
    fwd, bwd = tops.build_bsr_pair(g, br=8, bc=16, device="cpu")
    mha = tops.build_sparse_mha(fwd, bwd, inner)
    cuda = inner == "cuda"
    assert len(built) == int(cuda) and (fwd.nzc is not None) == cuda
    assert bwd.nzc is None
    z = torch.from_numpy(r.standard_normal((40, 3, 5)).astype(np.float32))
    a_src, a_dst = (torch.from_numpy(r.standard_normal((3, 5)).astype(np.float32))
                    for _ in range(2))
    grads = []
    for _ in range(2):
        zt, st, dt = (x.clone().requires_grad_(True) for x in (z, a_src, a_dst))
        mha(zt, st, dt).square().sum().backward()
        grads.append((zt.grad, st.grad, dt.grad))
    assert len(built) == int(cuda) and bwd.nzc is None
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
