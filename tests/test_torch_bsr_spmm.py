"""Port parity, kernel layer: ``repro_torch.kernels`` ``bsr_spmm`` (its plain
version, which the wrapper runs for CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its jnp reference, and
``bsr_spmm_pair``'s backward against ``jax.vjp``. The Hopper kernel itself
runs only on the card: its test is marked ``cuda`` and skips here.

Tolerance 1e-5 (absolute and relative, float32): the kernel, the plain
version and the Pallas interpreter sum the same products in different
orders."""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import NeighborSampler, _pad_bsr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bsr_spmm import TILES, bsr_spmm  # noqa: E402
from repro_torch.kernels.ref import bsr_spmm_ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the parity checks. Imported here, not at
    module level, so the card-marked test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ops
    from repro.kernels.bsr_spmm import bsr_spmm as pallas_bsr_spmm
    from repro.kernels.ref import bsr_spmm_ref as jnp_bsr_spmm_ref

    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops,
                                 bsr_spmm=pallas_bsr_spmm,
                                 bsr_spmm_ref=jnp_bsr_spmm_ref)


def _operand(seed, n_rows, n_cols, n_edges, br, bc, pad_to=0):
    """Flattened BSR of a random graph (explicit zero blocks on empty
    block-rows), optionally padded with the sampler's trailing zero blocks.
    Built with the port's copies of the JAX package's builders, which
    tests/test_torch_graph.py holds byte-identical."""
    r = np.random.default_rng(seed)
    g = csr_from_edges(r.integers(0, n_cols, n_edges),
                       r.integers(0, n_rows, n_edges), n_rows, n_cols=n_cols,
                       data=r.standard_normal(n_edges).astype(np.float32))
    bsr = csr_to_bsr(g, br=br, bc=bc)
    arrays = _pad_bsr(bsr, bsr.n_blocks + pad_to)
    return arrays, bsr.padded_rows, bsr.padded_cols, g


def _port(arrays, x, n_rows_padded):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return bsr_spmm(t["rows"], t["cols"], t["blocks"], torch.from_numpy(x),
                    n_rows_padded).numpy()


@pytest.mark.parametrize("f", [40, 13, 256])
@pytest.mark.parametrize("br,bc,pad", [(8, 8, 0), (8, 8, 5), (8, 16, 3),
                                       (16, 32, 0)])
def test_plain_bsr_spmm_matches_pallas_and_ref(jx, f, br, bc, pad):
    # 50 edges over 90 rows: many block-rows hold only their zero block
    arrays, nrp, ncp, g = _operand(f + br + pad, 90, 70, 50, br, bc, pad)
    x = np.random.default_rng(f).standard_normal((ncp, f)).astype(np.float32)
    y = _port(arrays, x, nrp)
    j = {k: jx.jnp.asarray(v) for k, v in arrays.items()}
    y_pallas = jx.bsr_spmm(j["rows"], j["cols"], j["first"], j["blocks"],
                           jx.jnp.asarray(x), n_rows_padded=nrp, bf=f,
                           interpret=True)
    y_ref = jx.bsr_spmm_ref(j["rows"], j["cols"], j["blocks"],
                            jx.jnp.asarray(x), nrp)
    assert y.shape == (nrp, f) and y.dtype == np.float32
    np.testing.assert_allclose(y, np.asarray(y_pallas), **TOL)
    np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(y[:90], g.to_dense() @ x[:70], **TOL)


def test_block_row_without_blocks_writes_zeros(jx):
    """A stream with no block at all for some block-rows (the kernel's
    row range is empty there): those output rows are zero."""
    arrays, nrp, ncp, g = _operand(1, 64, 64, 40, 8, 8)
    keep = np.isin(arrays["rows"], [0, 3, 5])
    kept = {k: v[keep] for k, v in arrays.items()}
    x = np.random.default_rng(2).standard_normal((ncp, 24)).astype(np.float32)
    y = _port(kept, x, nrp)
    jnp = jx.jnp
    y_ref = jx.bsr_spmm_ref(jnp.asarray(kept["rows"]), jnp.asarray(kept["cols"]),
                            jnp.asarray(kept["blocks"]), jnp.asarray(x), nrp)
    np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
    dense = g.to_dense() @ x
    rows = np.arange(64) // 8
    np.testing.assert_array_equal(y[~np.isin(rows, [0, 3, 5])], 0.0)
    np.testing.assert_allclose(y[np.isin(rows, [0, 3, 5])],
                               dense[np.isin(rows, [0, 3, 5])], **TOL)


def _sampled_pair(seed):
    """A sampled block's padded (A, Aᵀ) BSR pair, as the serving path
    feeds it: caps aligned to lcm(br, bc), trailing padding blocks."""
    r = np.random.default_rng(seed)
    n = 80
    g = csr_from_edges(np.concatenate([r.integers(0, n, 400), np.arange(n)]),
                       np.concatenate([r.integers(0, n, 400), np.arange(n)]),
                       n).sym_normalized()
    s = NeighborSampler(g, (4, 3), 8, n_buckets=1, br=8, bc=8, seed=seed)
    blk = s.sample_batch(np.arange(6))
    b0 = blk.blocks[0]
    return b0.fwd_bsr, b0.bwd_bsr, blk.bucket.node_caps[1], blk.bucket.node_caps[0]


@pytest.mark.parametrize("f", [40, 128])
@pytest.mark.parametrize("inner", ["cuda", "torch"])
def test_bsr_spmm_pair_forward_and_backward_match_jax_vjp(jx, f, inner):
    fwd, bwd, n_out, n_in = _sampled_pair(f)
    r = np.random.default_rng(f + 1)
    x = r.standard_normal((n_in, f)).astype(np.float32)
    dy = r.standard_normal((n_out, f)).astype(np.float32)
    order = ("rows", "cols", "first", "blocks")
    jnp = jx.jnp
    jf = tuple(jnp.asarray(fwd[k]) for k in order)
    jb = tuple(jnp.asarray(bwd[k]) for k in order)
    y_j, vjp = jx.jax.vjp(
        lambda v: jx.ops.bsr_spmm_pair(jf, jb, v, n_out, f, True, "pallas"),
        jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dy))

    tf = tuple(torch.from_numpy(fwd[k]) for k in order)
    tb = tuple(torch.from_numpy(bwd[k]) for k in order)
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = tops.bsr_spmm_pair(tf, tb, xt, n_out, inner)
    y_t.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)


def test_bsr_spmm_pair_without_transposed_operand_has_no_gradient():
    fwd, _, n_out, n_in = _sampled_pair(3)
    tf = tuple(torch.from_numpy(fwd[k]) for k in ("rows", "cols", "first", "blocks"))
    x = torch.ones((n_in, 8), requires_grad=True)
    y = tops.bsr_spmm_pair(tf, None, x, n_out, "cuda")
    with pytest.raises(RuntimeError, match="transposed operand"):
        y.sum().backward()


@pytest.mark.parametrize("f", [1, 40, 127, 128, 200, 256])
def test_feature_tile_matches_jax(jx, f):
    assert tops.feature_tile(f) == jx.ops.feature_tile(f)


def test_wrapper_rejects_bad_shapes_and_devices():
    arrays, nrp, ncp, _ = _operand(0, 16, 16, 20, 8, 8)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    x = torch.zeros((ncp, 4))
    with pytest.raises(ValueError, match="padded to the block-column"):
        bsr_spmm(t["rows"], t["cols"], t["blocks"], x[:-1], nrp)
    with pytest.raises(ValueError, match="multiple of br"):
        bsr_spmm(t["rows"], t["cols"], t["blocks"], x, nrp - 1)
    with pytest.raises(ValueError, match="block_rows/block_cols"):
        bsr_spmm(t["rows"][:-1], t["cols"], t["blocks"], x, nrp)
    # no silent fallback: only cpu (plain) and cuda (kernel) run
    with pytest.raises(ValueError, match="cuda or cpu"):
        bsr_spmm(t["rows"].to("meta"), t["cols"].to("meta"),
                 t["blocks"].to("meta"), x.to("meta"), nrp)
    launches = bsr_spmm.launches
    bsr_spmm(t["rows"], t["cols"], t["blocks"], x, nrp)
    assert bsr_spmm.launches == launches  # CPU calls launch no kernel


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the Hopper kernel against its plain version at 1e-4
    (different summation orders) for every built tile, over empty rows,
    padding blocks and ragged feature widths; bitwise repeatable across
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for (br, bc), f in itertools.product(TILES, (1, 40, 128, 200, 256)):
        arrays, nrp, ncp, _ = _operand(f, 150, 130, 300, br, bc, pad_to=7)
        t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
        x = torch.randn((ncp, f), generator=torch.Generator().manual_seed(f)).cuda()
        before = bsr_spmm.launches
        y = bsr_spmm(t["rows"], t["cols"], t["blocks"], x, nrp)
        y2 = bsr_spmm(t["rows"], t["cols"], t["blocks"], x, nrp)
        torch.cuda.synchronize()
        assert bsr_spmm.launches == before + 2
        ref = bsr_spmm_ref(t["rows"], t["cols"], t["blocks"], x, nrp)
        torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-4)
        assert torch.equal(y, y2)
