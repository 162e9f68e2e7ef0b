"""Port parity, fused-epilogue kernels: the plain versions of
``bsr_spmm_fused_epilogue`` and ``bsr_spmm_masked`` (which the wrappers run
for CPU tensors) against the JAX package's Pallas kernels in interpret mode
and its jnp oracle, and ``build_fused_epilogue``'s backward against
``jax.vjp`` of the JAX package's fused pair, including A and Aᵀ with
unequal paddings. The Hopper kernels run only on the card: their test is
marked ``cuda`` and skips here.

Tolerance 1e-4 (absolute and relative, float32), the fused-epilogue
tolerance of the JAX suite: the kernel, the plain version and the Pallas
interpreter sum the same products in different orders. ReLU masks are
compared only where the pre-activation is farther than 1e-5 from 0, since
a rounding difference may flip the sign there."""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import _pad_bsr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import bsr_spmm as bsr_spmm_module  # noqa: E402
from repro_torch.kernels.bsr_spmm import (  # noqa: E402
    TILES,
    _check_launch,
    _vec4,
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
MASK_MARGIN = 1e-5

#: (self_term, bias, activation): the epilogue specs the lowering emits —
#: GCN hidden / last layer, SAGE, GIN sparse (self·α + bias + ReLU), GIN
#: dense (self·α) — and ReLU alone
SPECS = {
    "gcn": (False, True, "relu"),
    "gcn_last": (False, True, "none"),
    "sage": (True, True, "relu"),
    "gin_sparse": (True, True, "relu"),
    "gin_dense": (True, False, "none"),
    "relu_only": (False, False, "relu"),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side. Imported here, not at module level, so the
    card-marked test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.graph.csr import csr_from_edges as jax_csr_from_edges
    from repro.kernels import bsr_spmm as jk
    from repro.kernels import ops
    from repro.kernels import ref

    return types.SimpleNamespace(jax=jax, jnp=jnp, k=jk, ops=ops, ref=ref,
                                 csr_from_edges=jax_csr_from_edges)


def _graph(seed, n_rows, n_cols, n_edges):
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, n_cols, n_edges), r.integers(0, n_rows, n_edges)
    data = r.standard_normal(n_edges).astype(np.float32)
    return src, dst, data


def _operand(seed, n_rows, n_cols, n_edges, br, bc, pad_to=0):
    """Flattened BSR of a random graph with explicit zero blocks on empty
    block-rows, optionally padded with the sampler's trailing zero
    blocks; ``last`` derived as the Pallas kernel needs it."""
    src, dst, data = _graph(seed, n_rows, n_cols, n_edges)
    g = csr_from_edges(src, dst, n_rows, n_cols=n_cols, data=data)
    bsr = csr_to_bsr(g, br=br, bc=bc)
    arrays = _pad_bsr(bsr, bsr.n_blocks + pad_to)
    last = np.ones_like(arrays["rows"])
    last[:-1] = (arrays["rows"][1:] != arrays["rows"][:-1]).astype(np.int32)
    arrays["last"] = last
    return arrays, bsr.padded_rows, bsr.padded_cols


def _inputs(seed, nrp, ncp, f):
    r = np.random.default_rng(seed)
    x = r.standard_normal((ncp, f)).astype(np.float32)
    s = r.standard_normal((nrp, f)).astype(np.float32)
    b = r.standard_normal(f).astype(np.float32)
    return x, s, b, np.float32(1.3)


def _port_fused(arrays, nrp, x, s, b, alpha, spec):
    has_self, has_bias, act = spec
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    y, mask = bsr_spmm_fused_epilogue(
        t["rows"], t["cols"], t["blocks"], torch.from_numpy(x), nrp,
        torch.from_numpy(s) if has_self else None,
        torch.from_numpy(b) if has_bias else None,
        torch.tensor([alpha]) if has_self else None, act)
    return y.numpy(), None if mask is None else mask.numpy()


def _assert_masks(mask, mask_ref, pre):
    far = np.abs(pre) > MASK_MARGIN
    np.testing.assert_array_equal(mask[far], mask_ref[far])
    assert set(np.unique(mask)) <= {0.0, 1.0}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_fused_matches_pallas(jx, name):
    """Every spec over a stream with explicit empty-row blocks and the
    sampler's padding tail (F=24, one lane tile for the interpreter)."""
    spec = SPECS[name]
    has_self, has_bias, act = spec
    arrays, nrp, ncp = _operand(len(name), 70, 60, 90, 8, 8, pad_to=5)
    f = 24
    x, s, b, alpha = _inputs(len(name) + 1, nrp, ncp, f)
    y, mask = _port_fused(arrays, nrp, x, s, b, alpha, spec)

    jnp = jx.jnp
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    out = jx.k.bsr_spmm_fused_epilogue(
        j["rows"], j["cols"], j["first"], j["last"], j["blocks"],
        jnp.asarray(x), jnp.asarray(s) if has_self else None,
        jnp.asarray(b)[None] if has_bias else None,
        jnp.float32(alpha) if has_self else None,
        n_rows_padded=nrp, bf=f, activation=act, interpret=True)
    y_p, mask_p = out if act == "relu" else (out, None)
    assert y.shape == (nrp, f) and y.dtype == np.float32
    np.testing.assert_allclose(y, np.asarray(y_p), **TOL)
    if act == "relu":
        pre, _ = jx.ref.bsr_spmm_fused_ref(
            j["rows"], j["cols"], j["blocks"], jnp.asarray(x), nrp,
            jnp.asarray(s) if has_self else None,
            jnp.asarray(b)[None] if has_bias else None,
            jnp.float32(alpha) if has_self else None, "none")
        _assert_masks(mask, np.asarray(mask_p), np.asarray(pre))
    else:
        assert mask is None


@pytest.mark.parametrize("f", [13, 40])
def test_plain_fused_ragged_f_and_rows_without_blocks(jx, f):
    """A ragged F and a stream that holds no block at all for some
    block-rows: those rows are act(alpha·self + bias), as in the oracle."""
    spec = SPECS["sage"]
    arrays, nrp, ncp = _operand(f, 64, 64, 60, 8, 16)
    keep = np.isin(arrays["rows"], [0, 2, 5, 7])
    kept = {k: v[keep] for k, v in arrays.items()}
    x, s, b, alpha = _inputs(f, nrp, ncp, f)
    y, mask = _port_fused(kept, nrp, x, s, b, alpha, spec)
    jnp = jx.jnp
    j = [jnp.asarray(kept[k]) for k in ("rows", "cols", "blocks")]
    operands = (jnp.asarray(x), nrp, jnp.asarray(s), jnp.asarray(b)[None],
                jnp.float32(alpha))
    y_o, mask_o = jx.ref.bsr_spmm_fused_ref(*j, *operands, "relu")
    pre, _ = jx.ref.bsr_spmm_fused_ref(*j, *operands, "none")
    np.testing.assert_allclose(y, np.asarray(y_o), **TOL)
    empty = ~np.isin(np.arange(nrp) // 8, [0, 2, 5, 7])
    np.testing.assert_allclose(y[empty],
                               np.maximum(alpha * s[empty] + b, 0.0), **TOL)
    _assert_masks(mask, np.asarray(mask_o), np.asarray(pre))


@pytest.mark.parametrize("f,pad", [(13, 0), (40, 6)])
def test_plain_masked_matches_pallas(jx, f, pad):
    arrays, nrp, ncp = _operand(f + pad, 60, 72, 90, 8, 8, pad_to=pad)
    r = np.random.default_rng(f)
    dy = r.standard_normal((ncp, f)).astype(np.float32)
    mask = (r.random((ncp, f)) < 0.5).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    y = bsr_spmm_masked(t["rows"], t["cols"], t["blocks"], torch.from_numpy(dy),
                        torch.from_numpy(mask), nrp).numpy()
    jnp = jx.jnp
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    y_p = jx.k.bsr_spmm_masked(j["rows"], j["cols"], j["first"], j["blocks"],
                               jnp.asarray(dy), jnp.asarray(mask),
                               n_rows_padded=nrp, bf=f, interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_p), **TOL)


def _pairs(jx, n_rows, n_cols, br, bc, seed=5):
    """The port's and the JAX package's (A, Aᵀ) BSR pairs of one graph."""
    src, dst, data = _graph(seed, n_rows, n_cols, 4 * n_rows)
    g = csr_from_edges(src, dst, n_rows, n_cols=n_cols, data=data)
    jg = jx.csr_from_edges(src, dst, n_rows, n_cols=n_cols, data=data)
    return (tops.build_bsr_pair(g, br=br, bc=bc, device="cpu"),
            jx.ops.build_bsr_pair(jg, br=br, bc=bc))


@pytest.mark.parametrize("name", ["gcn", "gcn_last", "gin_sparse", "gin_dense"])
@pytest.mark.parametrize("inner", ["cuda", "torch"])
def test_fused_pair_forward_and_vjp_match_jax(jx, name, inner):
    """100 nodes, 8x32 tiles: A's rows pad to 104, its columns to 128, so
    the backward re-tiles dY between A's and Aᵀ's paddings."""
    has_self, has_bias, act = SPECS[name]
    (fwd, bwd), (jf, jb) = _pairs(jx, 100, 100, 8, 32)
    assert (fwd.n_rows_padded, fwd.n_cols_padded) == (104, 128)
    r = np.random.default_rng(len(name))
    f = 40
    u, s = (r.standard_normal((100, f)).astype(np.float32) for _ in range(2))
    b = r.standard_normal(f).astype(np.float32)
    alpha = np.float32(0.7)
    dy = r.standard_normal((100, f)).astype(np.float32)

    jfused = jx.ops.build_fused_epilogue(jf, jb, "pallas", interpret=True)
    jnp = jx.jnp

    def jfn(u_, s_, b_, a_):
        return jfused(u_, self_term=s_ if has_self else None,
                      bias=b_ if has_bias else None,
                      alpha=a_ if has_self else None, activation=act)

    y_j, vjp = jx.jax.vjp(jfn, jnp.asarray(u), jnp.asarray(s),
                          jnp.asarray(b), jnp.float32(alpha))
    du_j, ds_j, db_j, da_j = vjp(jnp.asarray(dy))

    fused = tops.build_fused_epilogue(fwd, bwd, inner)
    ut, st, bt = (torch.from_numpy(a).requires_grad_(True) for a in (u, s, b))
    at = torch.tensor(float(alpha), requires_grad=True)
    y = fused(ut, self_term=st if has_self else None,
              bias=bt if has_bias else None,
              alpha=1.0 + (at - 1.0) if has_self else None, activation=act)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(du_j), **TOL)
    if has_self:
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(ds_j), **TOL)
        np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_j), **TOL)
    if has_bias:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db_j), **TOL)


def test_chunked_plain_spmm_matches_one_chunk(monkeypatch):
    """The plain versions walk the block stream in chunks: a few blocks per
    chunk gives the one-chunk result within 1e-6."""
    arrays, nrp, ncp = _operand(3, 90, 70, 200, 8, 16, pad_to=4)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ncp, 33)).astype(np.float32))
    small = 3 * 4 * 16 * 33  # three blocks of gathered X per chunk
    one = bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, nrp)
    monkeypatch.setattr(tref, "CHUNK_BYTES", small)
    many = bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, nrp)
    torch.testing.assert_close(many, one, atol=1e-6, rtol=1e-6)
    mask = (x > 0).float()
    torch.testing.assert_close(
        bsr_spmm_masked_ref(t["rows"], t["cols"], t["blocks"], x, mask, nrp),
        bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x * mask, nrp),
        atol=1e-6, rtol=1e-6)
    y, m = bsr_spmm_fused_ref(t["rows"], t["cols"], t["blocks"], x, nrp,
                              bias=torch.ones(33), activation="relu")
    torch.testing.assert_close(y, torch.relu(one + 1.0), atol=1e-6, rtol=1e-6)


def test_wrappers_reject_bad_specs_and_count_no_cpu_launches():
    arrays, nrp, ncp = _operand(0, 16, 16, 20, 8, 8)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x = torch.zeros((ncp, 4))
    s = torch.zeros((nrp, 4))
    with pytest.raises(ValueError, match="requires alpha"):
        bsr_spmm_fused_epilogue(t["rows"], t["cols"], t["blocks"], x, nrp, s)
    with pytest.raises(ValueError, match="activation"):
        bsr_spmm_fused_epilogue(t["rows"], t["cols"], t["blocks"], x, nrp,
                                activation="gelu")
    with pytest.raises(ValueError, match="self_term must be"):
        bsr_spmm_fused_epilogue(t["rows"], t["cols"], t["blocks"], x, nrp,
                                s[:-1], alpha=1.0)
    with pytest.raises(ValueError, match="mask shape"):
        bsr_spmm_masked(t["rows"], t["cols"], t["blocks"], x, x[:, :2], nrp)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bsr_spmm_masked(t["rows"].to("meta"), t["cols"].to("meta"),
                        t["blocks"].to("meta"), x.to("meta"), x.to("meta"), nrp)
    # what a CUDA launch is checked for, on CPU tensors
    _check_launch(block_rows=t["rows"], block_cols=t["cols"], blocks=t["blocks"],
                  x=x, self_term=s, bias=None, mask=x)
    with pytest.raises(TypeError, match="x must be torch.float32"):
        _check_launch(block_rows=t["rows"], block_cols=t["cols"],
                      blocks=t["blocks"], x=x.double())
    with pytest.raises(ValueError, match="self_term must be contiguous"):
        _check_launch(block_rows=t["rows"], block_cols=t["cols"],
                      blocks=t["blocks"], x=x, self_term=s.t())
    with pytest.raises(ValueError, match="tile"):
        _check_launch(block_rows=t["rows"], block_cols=t["cols"],
                      blocks=t["blocks"][:, :, :4].contiguous(), x=x)
    before = (bsr_spmm_fused_epilogue.launches, bsr_spmm_masked.launches)
    bsr_spmm_fused_epilogue(t["rows"], t["cols"], t["blocks"], x, nrp, s,
                            torch.ones(4), 1.0, "relu")
    bsr_spmm_masked(t["rows"], t["cols"], t["blocks"], x, x, nrp)
    assert (bsr_spmm_fused_epilogue.launches, bsr_spmm_masked.launches) == before


def _hub_operand(br, bc, n_cols=4096, seed=9):
    """One block-row whose nonzero columns (~1,500 over 32 blocks at
    bc=128) outnumber what one pass of the CTA's groups takes (groups x 8
    columns, and more than one staged chunk), beside short rows."""
    r = np.random.default_rng(seed)
    hub_src = r.integers(0, n_cols, 2000)
    hub_dst = r.integers(0, br, 2000)
    src = np.concatenate([hub_src, r.integers(0, n_cols, 300)])
    dst = np.concatenate([hub_dst, r.integers(br, 6 * br, 300)])
    data = r.standard_normal(src.size).astype(np.float32)
    g = csr_from_edges(src, dst, 6 * br, n_cols=n_cols, data=data)
    bsr = csr_to_bsr(g, br=br, bc=bc)
    return _pad_bsr(bsr, bsr.n_blocks + 3), bsr.padded_rows, bsr.padded_cols


def _misaligned(t):
    """A contiguous copy of ``t`` whose storage starts one float past a
    16-byte boundary: every row is misaligned for float4 loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _cuda_case(arrays, nrp, ncp, f, seed, misalign=False):
    """Both kernels against their plain versions on one operand: every
    epilogue spec and the masked product, each launched twice (bitwise
    equal, counted once each), the nonzero columns built once (rows past
    ``SPLIT_COLUMNS`` cut into segments) and passed."""
    t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((ncp, f), generator=g).cuda()
    s = torch.randn((nrp, f), generator=g).cuda()
    b = torch.randn(f, generator=g).cuda()
    mask = (torch.randn((ncp, f), generator=g) > 0).float().cuda()
    if misalign:
        x, s, mask = _misaligned(x), _misaligned(s), _misaligned(mask)
        assert not _vec4(f, x) and _vec4(f, x.clone())
    alpha = torch.full((1,), 0.8, device="cuda")
    for has_self, has_bias, act in SPECS.values():
        args = (t["rows"], t["cols"], t["blocks"], x, nrp,
                s if has_self else None, b if has_bias else None,
                alpha if has_self else None, act)
        before = bsr_spmm_fused_epilogue.launches
        y, m = bsr_spmm_fused_epilogue(*args, nzc=nzc)
        y2, m2 = bsr_spmm_fused_epilogue(*args, nzc=nzc)
        pre, _ = bsr_spmm_fused_ref(*args[:8], "none")
        y_ref, m_ref = bsr_spmm_fused_ref(*args)
        torch.cuda.synchronize()
        assert bsr_spmm_fused_epilogue.launches == before + 2
        torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
        assert torch.equal(y, y2)
        if act == "relu":
            far = pre.abs() > MASK_MARGIN
            assert torch.equal(m[far], m_ref[far]) and torch.equal(m, m2)
    margs = (t["rows"], t["cols"], t["blocks"], x, mask, nrp)
    before = bsr_spmm_masked.launches
    y = bsr_spmm_masked(*margs, nzc=nzc)
    y2 = bsr_spmm_masked(*margs, nzc=nzc)
    torch.cuda.synchronize()
    assert bsr_spmm_masked.launches == before + 2
    torch.testing.assert_close(y, bsr_spmm_masked_ref(*margs), atol=1e-4,
                               rtol=1e-4)
    assert torch.equal(y, y2)
    # a CUDA call never builds the operand itself
    with pytest.raises(ValueError, match="nonzero_columns"):
        bsr_spmm_masked(*margs)
    with pytest.raises(ValueError, match="nonzero_columns"):
        bsr_spmm_fused_epilogue(*margs[:4], nrp)


@pytest.mark.cuda
def test_cuda_fused_and_masked_kernels_match_plain(monkeypatch):
    """On the card: both Hopper kernels against their plain versions at
    1e-4 for every built tile, every epilogue spec, F = 1, 33, 40, 70,
    128, 200, 256 (ragged, scalar and float4 paths), over empty rows and
    padding blocks; rows misaligned for float4 (scalar path); a hub row
    longer than the CTA's split of its columns, in one CTA and cut into
    segments (2 at the default split, 16 at 100 columns); bitwise
    repeatable; each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    for (br, bc), f in itertools.product(TILES, (1, 33, 40, 70, 128, 200, 256)):
        arrays, nrp, ncp = _operand(f, 150, 130, 300, br, bc, pad_to=7)
        _cuda_case(arrays, nrp, ncp, f, seed=f)
    for br, bc in ((8, 128), (16, 64)):
        arrays, nrp, ncp = _operand(36, 150, 130, 300, br, bc, pad_to=7)
        _cuda_case(arrays, nrp, ncp, 36, seed=36, misalign=True)
        for f, split in itertools.product((40, 256), (100, 1024, 4096)):
            monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
            arrays, nrp, ncp = _hub_operand(br, bc)
            _cuda_case(arrays, nrp, ncp, f, seed=f + 1)
