"""Port parity, kernel layer: ``repro_torch.kernels`` ``bsr_spmm`` (its plain
version, which the wrapper runs for CPU tensors) against the JAX package's
Pallas kernel in interpret mode and its jnp reference, and
``bsr_spmm_pair``'s backward against ``jax.vjp``; the sampled path's
per-batch nonzero columns (one build per batch and layer) and its forward
against the JAX pair's; a CUDA call without the columns raises. The
Hopper kernel itself runs only on the card: its test is marked ``cuda``
and skips here.

Tolerance 1e-5 (absolute and relative, float32): the kernel, the plain
version and the Pallas interpreter sum the same products in different
orders; 1e-4 for the sampled path's forward, the JAX suite's SpMM
tolerance."""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import csr_from_edges, csr_to_bsr  # noqa: E402
from repro_torch.graph.sampling import NeighborSampler, _pad_bsr  # noqa: E402
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
from repro_torch.kernels.ref import bsr_spmm_ref  # noqa: E402
from repro_torch.models.gnn import GNNConfig  # noqa: E402
from repro_torch.training.trainer import MiniBatchTrainer  # noqa: E402

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


def test_sampled_batch_builds_one_operand_per_layer_and_matches_jax(jx, monkeypatch):
    """The serving path on the ``cuda`` backend (device cpu): a real
    sampler batch (8x8 buckets, the zero padding tail) gets one
    ``NonzeroColumns`` per layer, built by ``bsr_spmm_pair`` where the
    layer's product runs (the copy builds none); each layer's operand
    covers its block-rows with no padding column, and ``bsr_spmm_pair``
    matches the JAX package's ``bsr_spmm_pair`` forward (Pallas,
    interpret mode) within 1e-4, as does the walk over the columns that
    the kernel makes."""
    r = np.random.default_rng(4)
    n, f = 120, 16
    src = np.concatenate([r.integers(0, n, 700), np.arange(n)])
    dst = np.concatenate([r.integers(0, n, 700), np.arange(n)])
    feats = r.random((n, f)).astype(np.float32)
    tr = MiniBatchTrainer(GNNConfig(kind="GCN", layer_dims=[f, 12, 5]),
                          csr_from_edges(src, dst, n), feats, None, None,
                          None, fanouts=(5, 4), batch_size=16, n_buckets=2,
                          infer_only=True, device="cpu")
    built = []
    real = tops.nonzero_columns

    def counted(*args):
        built.append((args[3], real(*args)))
        return built[-1][1]

    monkeypatch.setattr(tops, "nonzero_columns", counted)
    batch = tr.sampler.sample_batch(np.arange(9), tr.features)
    data = tr._batch_arrays(batch)
    assert built == []
    tr._infer(tr.params, data)
    assert [b[0] for b in built] == [batch.valid[i + 1].shape[0] for i in range(2)]
    order = ("rows", "cols", "first", "blocks")
    for i, blk in enumerate(data["blocks"]):
        fwd = blk["fwd"]
        n_out, n_in = batch.valid[i + 1].shape[0], batch.valid[i].shape[0]
        x = r.standard_normal((n_in, f)).astype(np.float32)
        xt = torch.from_numpy(x)
        built.clear()
        y = tops.bsr_spmm_pair(tuple(fwd[k] for k in order), None, xt, n_out,
                               "cuda")
        assert len(built) == 1
        nzc = built[0][1]
        held = fwd["blocks"].ne(0).any(dim=1).sum()
        assert nzc.x_rows.numel() == int(held) and nzc.n_block_rows == n_out // 8
        padding = int((fwd["blocks"].reshape(fwd["blocks"].shape[0], -1)
                       .ne(0).any(dim=1) == 0).sum())
        assert padding > 0  # the bucket's padding tail, which gives no column
        y_j = jx.ops.bsr_spmm_pair(
            tuple(jx.jnp.asarray(fwd[k].numpy()) for k in order), None,
            jx.jnp.asarray(x), n_out, f, True, "pallas")
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
        walk = torch.zeros((n_out // 8, 8, f))
        for row, begin, end, slot in nzc.items.tolist():
            assert slot == -1  # no row of a bucket is past the split
            walk[row] = torch.einsum("nr,nf->rf", nzc.values[begin:end],
                                     xt[nzc.x_rows[begin:end].long()])
        np.testing.assert_allclose(walk.reshape(n_out, f).numpy(), np.asarray(y_j),
                                   atol=1e-4, rtol=1e-4)
    # the plain executor reads no columns, and none are built for it
    built.clear()
    tr._inner = "torch"
    tr._infer(tr.params, tr._batch_arrays(batch))
    assert built == []


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper does with a
    card's tensor before its first CUDA call, on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["bsr_spmm", "fused", "masked"])
def test_cuda_call_without_nzc_raises(kernel):
    """A CUDA call reads the operand's nonzero columns and never builds
    them itself: without ``nzc`` it raises before launching anything."""
    arrays, nrp, ncp, _ = _operand(0, 16, 16, 20, 8, 8)
    t = {k: torch.from_numpy(v).as_subclass(_OnCard) for k, v in arrays.items()}
    x = torch.zeros((ncp, 4)).as_subclass(_OnCard)
    assert x.device.type == "cuda"
    call = {"bsr_spmm": lambda: bsr_spmm(t["rows"], t["cols"], t["blocks"], x, nrp),
            "fused": lambda: bsr_spmm_fused_epilogue(t["rows"], t["cols"],
                                                     t["blocks"], x, nrp),
            "masked": lambda: bsr_spmm_masked(t["rows"], t["cols"], t["blocks"],
                                              x, x, nrp)}[kernel]
    launches = bsr_spmm.launches
    with pytest.raises(ValueError, match="needs nzc="):
        call()
    assert bsr_spmm.launches == launches


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


def _hub_operand(br, bc, n_cols=4096, seed=9):
    """One block-row whose ~1,500 nonzero columns (at bc=128) outnumber
    the split at 100 columns and one staged chunk, beside short rows."""
    r = np.random.default_rng(seed)
    src = np.concatenate([r.integers(0, n_cols, 2000), r.integers(0, n_cols, 300)])
    dst = np.concatenate([r.integers(0, br, 2000), r.integers(br, 6 * br, 300)])
    g = csr_from_edges(src, dst, 6 * br, n_cols=n_cols,
                       data=r.standard_normal(src.size).astype(np.float32))
    bsr = csr_to_bsr(g, br=br, bc=bc)
    return _pad_bsr(bsr, bsr.n_blocks + 3), bsr.padded_rows, bsr.padded_cols


def _cuda_case(arrays, nrp, ncp, f, seed, misalign=False):
    """The kernel over the operand's nonzero columns against its plain
    version on one operand, launched twice (bitwise equal, counted once
    each); a call without the columns raises."""
    t = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    nzc = nonzero_columns(t["rows"], t["cols"], t["blocks"], nrp)
    x = torch.randn((ncp, f), generator=torch.Generator().manual_seed(seed)).cuda()
    if misalign:
        buf = torch.empty(x.numel() + 1, device="cuda")
        x = buf[1:].view(x.shape).copy_(x)
        assert not _vec4(f, x)
    args = (t["rows"], t["cols"], t["blocks"], x, nrp)
    before = bsr_spmm.launches
    y = bsr_spmm(*args, nzc=nzc)
    y2 = bsr_spmm(*args, nzc=nzc)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 2
    torch.testing.assert_close(y, bsr_spmm_ref(*args), atol=1e-4, rtol=1e-4)
    assert torch.equal(y, y2)
    with pytest.raises(ValueError, match="nonzero_columns"):
        bsr_spmm(*args)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(monkeypatch):
    """On the card: the Hopper kernel, over the operand's nonzero columns,
    against its plain version at 1e-4 (different summation orders) for
    every built tile, F = 1, 33, 40, 70, 128, 200, 256 (ragged, scalar and
    float4, lanes not a power of two), over empty rows and padding blocks;
    rows misaligned for float4; a hub row in one CTA and cut into
    segments (16 at 100 columns); bitwise repeatable across launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for (br, bc), f in itertools.product(TILES, (1, 33, 40, 70, 128, 200, 256)):
        arrays, nrp, ncp, _ = _operand(f, 150, 130, 300, br, bc, pad_to=7)
        _cuda_case(arrays, nrp, ncp, f, seed=f)
    for br, bc in ((8, 128), (16, 64)):
        arrays, nrp, ncp, _ = _operand(36, 150, 130, 300, br, bc, pad_to=7)
        _cuda_case(arrays, nrp, ncp, 36, seed=36, misalign=True)
        for f, split in itertools.product((32, 40, 256), (100, 1024, 4096)):
            monkeypatch.setattr(bsr_spmm_module, "SPLIT_COLUMNS", split)
            arrays, nrp, ncp = _hub_operand(br, bc)
            _cuda_case(arrays, nrp, ncp, f, seed=f + 1)
