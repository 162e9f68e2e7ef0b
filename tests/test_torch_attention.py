"""Port parity, the edge-softmax attention kernels (DESIGN.md §10): the
plain versions of ``bsr_attention_fwd`` / ``_bwd_row`` / ``_bwd_col``
(which the wrappers run for CPU tensors) against the JAX package's Pallas
kernels in interpret mode and its jnp oracles; the online-softmax golden
case and the empty-row masking case of the JAX suite; a padded stream
tail; the autograd pair ``sparse_mha_pair`` against ``jax.vjp`` of the
JAX package's ``sparse_mha_pair`` (inner ``xla`` and ``pallas``) with
unequal paddings of A and Aᵀ; the segment path ``edge_softmax_aggregate``
with and without ``valid=``; and ``max`` aggregation. The Hopper kernels
run only on the card: their test is marked ``cuda`` and skips here.

Tolerance 1e-4 (absolute and relative, float32), the JAX suite's own: the
kernels, the plain versions and the Pallas interpreter sum in different
orders, and the plain version takes each row's true max where the kernels
run the online recurrence."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backends import get_backend  # noqa: E402
from repro_torch.backends.registry import edge_softmax_aggregate  # noqa: E402
from repro_torch.core.aggregate import gather_scatter_aggregate  # noqa: E402
from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bsr_attention import (  # noqa: E402
    bsr_attention_bwd_col,
    bsr_attention_bwd_row,
    bsr_attention_fwd,
)
from repro_torch.kernels.bsr_spmm import nonzero_columns  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    bsr_attention_bwd_col_ref,
    bsr_attention_bwd_row_ref,
    bsr_attention_fwd_ref,
)

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
HEADS_DH = [(1, 8), (3, 5), (2, 6)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side. Imported here, not at module level, so the
    card-marked test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.backends import get_backend as jax_backend
    from repro.backends.registry import edge_softmax_aggregate as jax_esa
    from repro.core.aggregate import gather_scatter_aggregate as jax_gsa
    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.kernels import bsr_attention as jk
    from repro.kernels import ops
    from repro.kernels import ref

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, k=jk, ops=ops, ref=ref, backend=jax_backend,
        esa=jax_esa, gsa=jax_gsa, csr_from_edges=jax_csr_from_edges)


def _edges(seed, n, e, n_src=None):
    """e random edges plus self loops on a square graph (or n_src sources)."""
    r = np.random.default_rng(seed)
    n_src = n if n_src is None else n_src
    k = min(n, n_src)
    return (np.concatenate([r.integers(0, n_src, e), np.arange(k)]),
            np.concatenate([r.integers(0, n, e), np.arange(k)]))


def _bsr(seed, n, e, bc):
    src, dst = _edges(seed, n, e)
    return csr_to_bsr(csr_from_edges(src, dst, n), br=8, bc=bc)


def _stream(bsr):
    return {"rows": bsr.block_rows, "cols": bsr.block_cols,
            "first": bsr.first_in_row, "last": bsr.last_in_row,
            "blocks": bsr.blocks}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _attn_inputs(seed, nrp, ncp, heads, dh):
    r = np.random.default_rng(seed)
    f32 = np.float32
    return dict(
        adst=r.standard_normal((nrp, heads)).astype(f32),
        asrc=r.standard_normal((ncp, heads)).astype(f32),
        z=r.standard_normal((ncp, heads * dh)).astype(f32),
        dy=r.standard_normal((nrp, heads * dh)).astype(f32),
        r=r.standard_normal((nrp, heads)).astype(f32))


def _jax_vjp(jx, fn, args, cot):
    """fn's value and its VJP at ``cot``, jitted as one program (faster to
    compile than op by op)."""
    def run(args, cot):
        out, vjp = jx.jax.vjp(fn, *args)
        return out, vjp(cot)

    j = jx.jnp.asarray
    return jx.jax.jit(run)(tuple(j(a) for a in args), j(cot))


def _port_fwd(s, v, nrp, heads):
    return bsr_attention_fwd(_t(s["rows"]), _t(s["cols"]), _t(s["blocks"]),
                             _t(v["adst"]), _t(v["asrc"]), _t(v["z"]), nrp,
                             heads)


@pytest.mark.parametrize("heads,dh", HEADS_DH)
@pytest.mark.parametrize("n,bc", [(33, 8), (120, None)])
def test_forward_matches_pallas_and_oracle(jx, heads, dh, n, bc):
    """bc=None: the adaptive width (128 for 120 nodes)."""
    bsr = _bsr(1, n, 4 * n, bc)
    s, nrp, ncp = _stream(bsr), bsr.padded_rows, bsr.padded_cols
    v = _attn_inputs(2, nrp, ncp, heads, dh)
    out, m, l = _port_fwd(s, v, nrp, heads)
    j = jx.jnp.asarray
    jo, jm, jl = jx.k.bsr_attention_fwd(
        j(s["rows"]), j(s["cols"]), j(s["first"]), j(s["last"]),
        j(s["blocks"]), j(v["adst"]), j(v["asrc"]), j(v["z"]),
        n_rows_padded=nrp, heads=heads, dh=dh, interpret=True)
    ro, rm, rl = jx.jax.jit(jx.ref.bsr_attention_ref, static_argnums=6)(
        j(s["rows"]), j(s["cols"]), j(s["blocks"]),
        j(v["z"]).reshape(ncp, heads, dh), j(v["asrc"]), j(v["adst"]), nrp)
    for got, pallas, oracle in ((out, jo, ro.reshape(nrp, -1)), (m, jm, rm),
                                (l, jl, rl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("heads,dh", HEADS_DH)
@pytest.mark.parametrize("n,bc", [(33, 8), (120, None)])
def test_backward_passes_match_pallas_and_oracle(jx, heads, dh, n, bc):
    """The row pass over A and the column pass over Aᵀ against the Pallas
    kernels (the column pass also over Aᵀ) and against the JAX oracle,
    which takes all three reductions over A; (m, l) from the forward."""
    src, dst = _edges(3, n, 4 * n)
    g = csr_from_edges(src, dst, n)
    a, at = csr_to_bsr(g, br=8, bc=bc), csr_to_bsr(g.transpose(), br=8, bc=bc)
    s, st = _stream(a), _stream(at)
    nrp, ncp = a.padded_rows, a.padded_cols
    v = _attn_inputs(4, nrp, ncp, heads, dh)
    out, m, l = _port_fwd(s, v, nrp, heads)
    m, l = m.numpy(), l.numpy()
    dc = bsr_attention_bwd_row(
        _t(s["rows"]), _t(s["cols"]), _t(s["blocks"]), _t(v["adst"]),
        _t(v["asrc"]), _t(v["z"]), _t(v["dy"]), _t(v["r"]), _t(m), _t(l),
        nrp, heads)
    # Aᵀ: sources are its rows (at.padded_rows), destinations its columns
    ntr, ntc = at.padded_rows, at.padded_cols

    def fit(x, rows):
        out = np.zeros((rows, x.shape[1]), np.float32)
        k = min(rows, x.shape[0])
        out[:k] = x[:k]
        return out

    col_args = (fit(v["asrc"], ntr), fit(v["adst"], ntc), fit(v["z"], ntr),
                fit(v["dy"], ntc), fit(v["r"], ntc), fit(m, ntc), fit(l, ntc))
    dzv, dd = bsr_attention_bwd_col(_t(st["rows"]), _t(st["cols"]),
                                    _t(st["blocks"]), *map(_t, col_args),
                                    ntr, heads)
    j = jx.jnp.asarray
    jdc = jx.k.bsr_attention_bwd_row(
        j(s["rows"]), j(s["cols"]), j(s["first"]), j(s["blocks"]),
        j(v["adst"]), j(v["asrc"]), j(v["z"]), j(v["dy"]), j(v["r"]), j(m),
        j(l), n_rows_padded=nrp, heads=heads, dh=dh, interpret=True)
    jdzv, jdd = jx.k.bsr_attention_bwd_col(
        j(st["rows"]), j(st["cols"]), j(st["first"]), j(st["blocks"]),
        *map(j, col_args), n_rows_padded=ntr, heads=heads, dh=dh,
        interpret=True)
    rdzv, rdd, rdc = jx.jax.jit(jx.ref.bsr_attention_bwd_ref,
                                static_argnums=10)(
        j(s["rows"]), j(s["cols"]), j(s["blocks"]),
        j(v["z"]).reshape(ncp, heads, dh), j(v["asrc"]), j(v["adst"]), j(m),
        j(l), j(v["dy"]).reshape(nrp, heads, dh), j(v["r"]), nrp)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), **TOL)
    np.testing.assert_allclose(dc.numpy(), np.asarray(rdc), **TOL)
    np.testing.assert_allclose(dzv.numpy(), np.asarray(jdzv), **TOL)
    np.testing.assert_allclose(dd.numpy(), np.asarray(jdd), **TOL)
    k = min(ntr, ncp)
    np.testing.assert_allclose(dzv.numpy()[:k],
                               np.asarray(rdzv).reshape(ncp, -1)[:k], **TOL)
    np.testing.assert_allclose(dd.numpy()[:k], np.asarray(rdd)[:k], **TOL)


def test_online_softmax_golden_case(jx):
    """The JAX suite's golden case: one destination row over two 4x4
    blocks whose second block holds the max, pinned against the dense
    softmax, closed-form (m, l) and the Pallas kernel."""
    br = bc = 4
    blocks = np.zeros((2, br, bc), np.float32)
    blocks[0, 0, :2] = 1.0   # dst 0 attends src {0, 1} in block 0
    blocks[1, 0, 2:] = 1.0   # ... and src {6, 7} in block 1
    blocks[0, 1, 1] = 1.0    # dst 1 attends src {1} only
    s = {"rows": np.array([0, 0], np.int32), "cols": np.array([0, 1], np.int32),
         "first": np.array([1, 0], np.int32), "last": np.array([0, 1], np.int32),
         "blocks": blocks}
    z = np.random.default_rng(7).standard_normal((8, 4)).astype(np.float32)
    adst = np.array([[0.3], [-0.2], [0.0], [0.0]], np.float32)
    asrc = np.array([[-1.0], [0.5], [0.0], [0.0], [0.0], [0.0], [4.0], [6.0]],
                    np.float32)
    out, m, l = _port_fwd(s, {"adst": adst, "asrc": asrc, "z": z}, 4, 1)

    def leaky(v):
        return np.where(v >= 0, v, 0.2 * v)

    for i, nbrs in ((0, [0, 1, 6, 7]), (1, [1])):
        sc = leaky(adst[i, 0] + asrc[nbrs, 0])
        att = np.exp(sc - sc.max())
        np.testing.assert_allclose(out.numpy()[i], att @ z[nbrs] / att.sum(),
                                   atol=1e-5, rtol=1e-5)
        assert float(m[i, 0]) == pytest.approx(sc.max(), abs=1e-6)
        assert float(l[i, 0]) == pytest.approx(att.sum(), abs=1e-5)
    assert float(m[0, 0]) == pytest.approx(leaky(0.3 + 6.0), abs=1e-6)
    j = jx.jnp.asarray
    jo, jm, jl = jx.k.bsr_attention_fwd(
        *(j(s[k]) for k in ("rows", "cols", "first", "last", "blocks")),
        j(adst), j(asrc), j(z), n_rows_padded=4, heads=1, dh=4, interpret=True)
    for got, want in ((out, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("inner", ["cuda", "torch"])
def test_empty_rows_are_masked(inner):
    """Destinations without in-edges (explicit zero blocks) give zero
    output, finite stats m = 0, l = 0, and finite gradients."""
    n = 24
    r = np.random.default_rng(0)
    src = np.concatenate([r.integers(0, n, 120), np.arange(16)])
    dst = np.concatenate([r.integers(0, 16, 120), np.arange(16)])
    g = csr_from_edges(src, dst, n)
    fwd, bwd = tops.build_bsr_pair(g, br=8, bc=8, device="cpu")
    z = torch.randn((n, 2, 4), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    a_src = torch.randn((2, 4), requires_grad=True)
    a_dst = torch.randn((2, 4), requires_grad=True)
    out = tops.build_sparse_mha(fwd, bwd, inner)(z, a_src, a_dst)
    assert torch.all(out[16:] == 0.0) and torch.isfinite(out).all()
    out.sum().backward()
    for t in (z, a_src, a_dst):
        assert torch.isfinite(t.grad).all()
    zp = tops._fit_rows(z.detach().reshape(n, 8), fwd.n_cols_padded)
    asrc = torch.einsum("nhd,hd->nh", z.detach(), a_src.detach())
    _, m, l = bsr_attention_fwd(fwd.block_rows, fwd.block_cols, fwd.blocks,
                                tops._fit_rows(asrc, fwd.n_rows_padded),
                                tops._fit_rows(asrc, fwd.n_cols_padded), zp,
                                fwd.n_rows_padded, 2)
    assert torch.all(m[16:] == 0.0) and torch.all(l[16:] == 0.0)


def test_padding_tail_changes_nothing():
    """The sampler's trailing zero blocks (on the last block-row, block
    column 0) contribute nothing to any of the three passes."""
    bsr = _bsr(5, 40, 160, 8)
    nrp, ncp, heads = bsr.padded_rows, bsr.padded_cols, 2
    v = _attn_inputs(6, nrp, ncp, heads, 3)
    t = {k: _t(a) for k, a in _stream(bsr).items()}
    p = {k: _t(a) for k, a in _pad_bsr(bsr, bsr.n_blocks + 7).items()}
    args = [_t(v[k]) for k in ("adst", "asrc", "z")]
    for fn, extra in ((bsr_attention_fwd_ref, ()),
                      (bsr_attention_bwd_row_ref,
                       tuple(_t(v[k]) for k in ("dy", "r"))
                       + (_t(np.abs(v["r"])), _t(1 + np.abs(v["r"]))))):
        a = fn(t["rows"], t["cols"], t["blocks"], *args, *extra, nrp, heads)
        b = fn(p["rows"], p["cols"], p["blocks"], *args, *extra, nrp, heads)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)
    col = (_t(v["asrc"]), _t(v["adst"]), _t(v["z"]), _t(v["dy"]), _t(v["r"]),
           _t(np.abs(v["r"])), _t(1 + np.abs(v["r"])))
    a = bsr_attention_bwd_col_ref(t["rows"], t["cols"], t["blocks"], *col,
                                  nrp, heads)
    b = bsr_attention_bwd_col_ref(p["rows"], p["cols"], p["blocks"], *col,
                                  nrp, heads)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **TOL)


@pytest.mark.parametrize("jax_inner", ["xla", "pallas"])
@pytest.mark.parametrize("heads,dh", [(3, 5), (2, 6)])
def test_sparse_mha_pair_matches_jax_vjp(jx, jax_inner, heads, dh):
    """Forward and gradients in z, a_src, a_dst of the port's pair (inner
    ``cuda``: the plain versions on the CPU) against ``jax.vjp`` of the JAX
    pair, on A and Aᵀ whose paddings differ (150 rows padded to 152, 160
    columns at the adaptive bc = 32)."""
    n = 150
    src, dst = _edges(8, n, 5 * n)
    g = csr_from_edges(src, dst, n)
    fwd, bwd = tops.build_bsr_pair(g, device="cpu")
    assert fwd.n_rows_padded != fwd.n_cols_padded
    jg = jx.csr_from_edges(src, dst, n)
    jb = jx.backend(jax_inner)
    jf, jbw = jb.build_spmm_operand(jg), jb.build_spmm_operand(jg.transpose())
    jmha = jx.ops.build_sparse_mha(jf, jbw, jax_inner, interpret=True)
    r = np.random.default_rng(9)
    z = r.standard_normal((n, heads, dh)).astype(np.float32)
    a_src = r.standard_normal((heads, dh)).astype(np.float32)
    a_dst = r.standard_normal((heads, dh)).astype(np.float32)
    cot = r.standard_normal((n, heads, dh)).astype(np.float32)
    j = jx.jnp.asarray
    jout, jgrads = _jax_vjp(jx, jmha, (z, a_src, a_dst), cot)
    tz, ts, td = (_t(a).requires_grad_(True) for a in (z, a_src, a_dst))
    out = tops.build_sparse_mha(fwd, bwd, "cuda")(tz, ts, td)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for got, want in zip((tz.grad, ts.grad, td.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_valid", [False, True])
def test_edge_softmax_aggregate_matches_jax(jx, with_valid):
    """The segment path, values and gradients, with -1-padded edges routed
    to the dump segment under ``valid=``; a node without in-edges."""
    n, heads, dh = 30, 3, 4
    src, dst = _edges(10, n - 1, 90)  # node n-1 has no edge at all
    if with_valid:
        pad = 11
        valid = np.concatenate([np.ones(src.size, bool), np.zeros(pad, bool)])
        src = np.concatenate([src, -np.ones(pad, src.dtype)])
        dst = np.concatenate([dst, -np.ones(pad, dst.dtype)])
    r = np.random.default_rng(12)
    z = r.standard_normal((n, heads, dh)).astype(np.float32)
    a_src = r.standard_normal((heads, dh)).astype(np.float32)
    a_dst = r.standard_normal((heads, dh)).astype(np.float32)
    cot = r.standard_normal((n, heads, dh)).astype(np.float32)
    j = jx.jnp.asarray
    jv = j(valid) if with_valid else None

    def jfn(z_, s_, d_):
        return jx.esa(z_, s_, d_, j(src), j(dst), n, valid=jv)

    jout, jgrads = _jax_vjp(jx, jfn, (z, a_src, a_dst), cot)
    tz, ts, td = (_t(a).requires_grad_(True) for a in (z, a_src, a_dst))
    out = edge_softmax_aggregate(tz, ts, td, _t(src), _t(dst), n,
                                 valid=_t(valid) if with_valid else None)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert torch.all(out[n - 1] == 0.0)
    for got, want in zip((tz.grad, ts.grad, td.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_max_aggregation_matches_jax(jx):
    """``max``: the unweighted messages' per-destination max, -inf on a node
    without in-edges as ``jax.ops.segment_max`` gives; gradients (ties
    shared equally) against ``jax.vjp``, the -inf row's cotangent zero."""
    n, f = 20, 6
    src, dst = _edges(13, n - 1, 60)  # node n-1 receives nothing
    r = np.random.default_rng(14)
    x = r.standard_normal((n, f)).astype(np.float32)
    x[3] = x[4]  # a tie where 3 and 4 feed the same destination
    src = np.concatenate([src, [3, 4]])
    dst = np.concatenate([dst, [7, 7]])
    w = r.standard_normal(src.size).astype(np.float32)
    cot = r.standard_normal((n, f)).astype(np.float32)
    cot[n - 1] = 0.0
    j = jx.jnp.asarray
    jout, (jgrad,) = _jax_vjp(
        jx, lambda x_: jx.gsa(j(src), j(dst), j(w), x_, n, "max"), (x,), cot)
    tx = _t(x).requires_grad_(True)
    out = gather_scatter_aggregate(_t(src), _t(dst), _t(w), tx, n, "max")
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    assert torch.all(torch.isneginf(out[n - 1]))
    out.backward(_t(cot))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), **TOL)


def test_backends_serve_attention():
    """``cuda``/``torch`` bind the fused pair, ``gather`` the segment path
    over its edge list; all three agree (plain versions on the CPU)."""
    n = 40
    src, dst = _edges(15, n, 160)
    g = csr_from_edges(src, dst, n)
    z = torch.randn((n, 2 * 3), generator=torch.Generator().manual_seed(2))
    a_src, a_dst = torch.randn((2, 3)), torch.randn((2, 3))
    outs = []
    for name in ("cuda", "torch", "gather"):
        b = get_backend(name)
        f = b.build_spmm_operand(g, device="cpu")
        t = b.build_spmm_operand(g.transpose(), device="cpu")
        outs.append(b.spmm_attention(f, t)(z, a_src, a_dst, 2))
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), **TOL)


def test_wrappers_check_shapes():
    bsr = _bsr(16, 24, 60, 8)
    t = {k: _t(a) for k, a in _stream(bsr).items()}
    nrp, ncp = bsr.padded_rows, bsr.padded_cols
    adst, asrc = torch.zeros((nrp, 2)), torch.zeros((ncp, 2))
    with pytest.raises(ValueError, match="multiple of heads"):
        bsr_attention_fwd(t["rows"], t["cols"], t["blocks"], adst, asrc,
                          torch.zeros((ncp, 7)), nrp, 2)
    with pytest.raises(ValueError, match="padded to bc"):
        bsr_attention_fwd(t["rows"], t["cols"], t["blocks"], adst,
                          asrc[:-1], torch.zeros((ncp - 1, 6)), nrp, 2)
    with pytest.raises(ValueError, match="column side"):
        bsr_attention_fwd(t["rows"], t["cols"], t["blocks"], adst,
                          asrc[:-8], torch.zeros((ncp, 6)), nrp, 2)
    with pytest.raises(ValueError, match="multiple of br"):
        bsr_attention_fwd(t["rows"], t["cols"], t["blocks"], adst, asrc,
                          torch.zeros((ncp, 6)), nrp - 1, 2)


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain():
    """On the card: the three kernels against their plain versions on the
    same device tensors at 1e-4 (a padded tail, rows without blocks, a
    row whose max lies in its second block, H·Dh not a multiple of 32, Dh
    250 at 3 heads; the row pass through A's nonzero columns), and a
    repeat launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cases = [(60, 240, 8, 2, 5), (300, 1500, None, 3, 250),
             (300, 1500, None, 3, 13), (100, 400, 16, 4, 17)]
    for seed, (n, e, bc, heads, dh) in enumerate(cases):
        bsr = _bsr(20 + seed, n, e, bc)
        arrays = _pad_bsr(bsr, bsr.n_blocks + 5)
        keep = arrays["rows"] != 1  # block-row 1 loses all its blocks
        arrays = {k: a[keep] for k, a in arrays.items()}
        t = {k: _t(a).cuda() for k, a in arrays.items()}
        nrp, ncp = bsr.padded_rows, bsr.padded_cols
        v = {k: _t(a).cuda() for k, a in
             _attn_inputs(30 + seed, nrp, ncp, heads, dh).items()}
        base = (t["rows"], t["cols"], t["blocks"])
        fargs = (*base, v["adst"], v["asrc"], v["z"], nrp, heads)
        got = bsr_attention_fwd(*fargs)
        again = bsr_attention_fwd(*fargs)
        want = bsr_attention_fwd_ref(*fargs)
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **TOL)
        m, l = want[1], want[2]
        assert torch.all(got[0][8:16] == 0) and torch.all(m[8:16] == 0)
        rargs = (*base, v["adst"], v["asrc"], v["z"], v["dy"], v["r"], m, l,
                 nrp, heads)
        nzc = nonzero_columns(*base, nrp)  # the row pass reads A's columns
        got = bsr_attention_bwd_row(*rargs, nzc=nzc)
        assert torch.equal(got, bsr_attention_bwd_row(*rargs, nzc=nzc))
        np.testing.assert_allclose(got.cpu().numpy(),
                                   bsr_attention_bwd_row_ref(*rargs).cpu().numpy(),
                                   **TOL)
        # the column pass on the same stream read as Aᵀ: its rows are the
        # sources, its columns the destinations
        fit = tops._fit_rows
        cargs = (*base, fit(v["asrc"], nrp).contiguous(),
                 fit(v["adst"], ncp).contiguous(), fit(v["z"], nrp).contiguous(),
                 fit(v["dy"], ncp).contiguous(), fit(v["r"], ncp).contiguous(),
                 fit(m, ncp).contiguous(), (fit(l, ncp) + 1.0).contiguous(),
                 nrp, heads)
        got = bsr_attention_bwd_col(*cargs)
        again = bsr_attention_bwd_col(*cargs)
        want = bsr_attention_bwd_col_ref(*cargs)
        torch.cuda.synchronize()
        for a, b, c in zip(got, again, want):
            assert torch.equal(a, b)
            np.testing.assert_allclose(a.cpu().numpy(), c.cpu().numpy(), **TOL)
