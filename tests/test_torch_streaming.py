"""Port parity, host-streamed strips (``repro_torch/runtime/streaming.py``):
``HostStrips`` and ``build_streamed_operand`` give the JAX package's bytes;
``streamed_spmm`` and a streamed GCN step give its numbers; the fetch's
host half (the fault hook, the retry, the checksums) fails as the JAX
package's does; ``bsr_spmm``'s accumulate mode adds into its output.

The JAX package is reached only through fixtures, so the card-marked tests
(the accumulate kernel on a split row, streamed against resident) collect
where JAX is absent.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.csr import CSRGraph, csr_to_bsr  # noqa: E402
from repro_torch.graph.datasets import generate_dataset  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.ref import bsr_spmm_accum_ref, bsr_spmm_ref  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    RetryPolicy,
    StreamFetchError,
    StripChecksumError,
)
from repro_torch.runtime.streaming import (  # noqa: E402
    HostStrips,
    build_streamed_operand,
    streamed_spmm,
)

torch.set_num_threads(1)

#: (scale, budget): corafull at 48 KiB (JAX ``test_overlap.py:203``'s), a
#: budget whose cuts land inside block-rows, and one strip
BUDGETS = [(0.008, 48 * 1024), (0.008, 13 * 1024), (0.008, 1 << 20)]


@pytest.fixture(scope="module")
def jax_mods():
    import jax
    import jax.numpy as jnp

    from repro.graph import datasets as jds
    from repro.runtime import streaming as jst

    return jax, jnp, jds, jst


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _splits_a_row(strips) -> bool:
    """A strip boundary inside a block-row: strip s - 1 ends where s starts."""
    return any(strips.rows[s - 1][-1] == strips.rows[s][0]
               for s in range(1, strips.n_strips))


@pytest.mark.parametrize("scale,budget", BUDGETS)
def test_strips_byte_equal_to_jax(jax_mods, scale, budget):
    """Every array of both operands (rows, cols, blocks and the build-time
    checksums, the strip padding included), the order and the shard
    offsets are JAX's bytes; ``device_nbytes`` / ``total_nbytes`` keep
    JAX's reckoning."""
    _, _, jds, jst = jax_mods
    j = jst.build_streamed_operand(jds.generate_dataset("corafull", scale=scale, seed=0).graph,
                                   "gcn", k_shards=4, budget_bytes=budget,
                                   verify_fetch=True)
    t = build_streamed_operand(generate_dataset("corafull", scale=scale, seed=0).graph,
                               "gcn", k_shards=4, budget_bytes=budget,
                               verify_fetch=True)
    _same(j.order, t.order, "order")
    _same(j.shard_offsets, t.shard_offsets, "shard_offsets")
    for side in ("fwd", "bwd"):
        a, b = getattr(j, side), getattr(t, side)
        for f in ("rows", "cols", "blocks", "checksums"):
            _same(getattr(a, f), getattr(b, f), f"{side}.{f}")
        assert (a.n_rows, a.n_cols, a.n_rows_padded, a.n_cols_padded, a.n_blocks,
                a.name) == (b.n_rows, b.n_cols, b.n_rows_padded, b.n_cols_padded,
                            b.n_blocks, b.name)
        assert a.device_nbytes() == b.device_nbytes()
        assert a.total_nbytes() == b.total_nbytes()
        assert len(b.columns) == b.n_strips
    assert j.device_nbytes() == t.device_nbytes()
    assert j.total_nbytes() == t.total_nbytes()
    if budget == 13 * 1024:
        assert t.fwd.n_strips > 8 and _splits_a_row(t.fwd) and _splits_a_row(t.bwd)
    if budget == 1 << 20:
        assert t.fwd.n_strips == 1


def test_streamed_spmm_matches_jax(jax_mods):
    """JAX ``test_overlap.py:203``'s case through both packages: the
    forward and the gradient of sum(y²) within 1e-4, two strips at most
    on the device, the operand larger than that."""
    jax, jnp, jds, jst = jax_mods
    jop = jst.build_streamed_operand(jds.generate_dataset("corafull", scale=0.008, seed=0).graph,
                                     aggregation="gcn", k_shards=4,
                                     budget_bytes=48 * 1024)
    op = build_streamed_operand(generate_dataset("corafull", scale=0.008, seed=0).graph,
                                aggregation="gcn", k_shards=4, budget_bytes=48 * 1024)
    assert op.fwd.n_strips > 1 and op.bwd.n_strips > 1
    assert op.device_nbytes() <= 48 * 1024 < op.total_nbytes()
    x = np.random.default_rng(0).standard_normal((op.n_nodes, 12)).astype(np.float32)
    y_j = np.asarray(jax.jit(lambda u: jst.streamed_spmm(jop.fwd, jop.bwd, u))(x))
    g_j = np.asarray(jax.jit(jax.grad(
        lambda u: jnp.sum(jst.streamed_spmm(jop.fwd, jop.bwd, u) ** 2)))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = streamed_spmm(op.fwd, op.bwd, xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, atol=1e-4, rtol=0)


def test_streamed_training_step_matches_jax(jax_mods):
    """JAX ``test_overlap.py:240``'s case: a 2-layer GCN on streamed
    operands through ``pipelined_value_and_grad`` in both packages from
    the same weights (``params_from_jax``): the loss and every gradient
    leaf within 1e-4."""
    jax, jnp, jds, jst = jax_mods
    from repro.core.pipeline import arch_layer_fns as j_layer_fns
    from repro.core.pipeline import pipelined_value_and_grad as j_pvg
    from repro.models.gnn import GNNConfig as JConfig
    from repro.models.gnn import LayerOps as JLayerOps
    from repro.models.gnn import init_params as j_init
    from repro_torch.core.pipeline import arch_layer_fns, pipelined_value_and_grad
    from repro_torch.models.gnn import GNNConfig, LayerOps, params_from_jax
    from repro_torch.training.optimizer import tree_leaves

    jds_ = jds.generate_dataset("corafull", scale=0.006, seed=0)
    dims = [jds_.features.shape[1], 8, jds_.n_classes]
    jcfg = JConfig(kind="GCN", layer_dims=dims, aggregation="gcn")
    jop = jst.build_streamed_operand(jds_.graph, aggregation="gcn", k_shards=2,
                                     budget_bytes=32 * 1024)
    jparams = j_init(jcfg, jax.random.PRNGKey(1))
    x, labels, mask = (jnp.asarray(a[jop.order]) for a in
                       (jds_.features, jds_.labels, jds_.train_mask))
    fns = j_layer_fns(jcfg, [JLayerOps(aggregate=jop.aggregate)] * 2)
    loss_j, grads_j = jax.jit(lambda p: j_pvg(fns, p, x, labels, mask))(jparams)

    ds = generate_dataset("corafull", scale=0.006, seed=0)
    cfg = GNNConfig(kind="GCN", layer_dims=dims, aggregation="gcn")
    op = build_streamed_operand(ds.graph, aggregation="gcn", k_shards=2,
                                budget_bytes=32 * 1024)
    assert op.fwd.n_strips > 1 and op.bwd.n_strips > 1
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    xt, lt, mt = (torch.from_numpy(a[op.order]) for a in
                  (ds.features, ds.labels, ds.train_mask))
    loss, grads = pipelined_value_and_grad(
        arch_layer_fns(cfg, [LayerOps(aggregate=op.aggregate)] * 2), params,
        xt, lt, mt, mt.sum().float().clamp(min=1.0))
    assert abs(float(loss) - float(loss_j)) < 1e-4
    got, want = tree_leaves(grads), jax.tree_util.tree_leaves(grads_j)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the fetch's host half: retries, context, checksums
# ---------------------------------------------------------------------------


def _stream_graph(rng, n=64):
    dense = (rng.random((n, n)) < 0.15).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum((dense > 0).sum(1))])
    indices = np.concatenate([np.flatnonzero(r) for r in dense])
    return dict(indptr=indptr.astype(np.int32), indices=indices.astype(np.int32),
                data=np.ones(indices.shape[0], np.float32), n_rows=n, n_cols=n)


def test_transient_fault_retries_to_the_same_y():
    """JAX ``test_resilience.py:345``: a fault that fails strip 1's fetch
    twice is retried through to the clean run's y, bitwise here."""
    rng = np.random.default_rng(0)
    g = CSRGraph(**_stream_graph(rng))
    x = rng.random((64, 8)).astype(np.float32)
    clean = build_streamed_operand(g, "sum", k_shards=2, budget_bytes=4096)
    y0 = streamed_spmm(clean.fwd, clean.bwd, torch.from_numpy(x[clean.order]))
    inj = FaultInjector(seed=0, faults=[FaultSpec(site="prefetch", prob=1.0, count=2)])
    op = build_streamed_operand(
        g, "sum", k_shards=2, budget_bytes=4096, shard_id=3,
        retry=RetryPolicy(max_retries=3, base_delay_s=1e-5, max_delay_s=1e-4))
    hook = inj.callback_hook("prefetch")
    op.fwd.fault_hook = lambda i: hook(("fwd", i)) if i == 1 else None
    y1 = streamed_spmm(op.fwd, op.bwd, torch.from_numpy(x[op.order]))
    assert torch.equal(y0, y1)
    assert inj.fired["prefetch"] == 2  # two failures, both retried through


def test_permanent_fault_carries_jax_context(jax_mods):
    """JAX ``test_resilience.py:367``: a fault on every fetch surfaces as
    ``StreamFetchError`` naming strip 0, operand 'fwd', shard 7 and 2
    attempts, in JAX's words."""
    jax, jnp, _, jst = jax_mods
    from repro.graph.csr import CSRGraph as JCSR
    from repro.runtime.resilience import FaultInjector as JInjector
    from repro.runtime.resilience import FaultSpec as JSpec
    from repro.runtime.resilience import RetryPolicy as JRetry

    def run(pkg_graph, build, injector, spec, retry, apply):
        rng = np.random.default_rng(0)
        g = pkg_graph(**_stream_graph(rng))
        x = rng.random((64, 8)).astype(np.float32)
        inj = injector(seed=0, faults=[spec(site="prefetch", prob=1.0)])
        op = build(g, "sum", k_shards=2, budget_bytes=4096,
                   retry=retry(max_retries=1, base_delay_s=1e-5), shard_id=7)
        hook = inj.callback_hook("prefetch")
        op.fwd.fault_hook = lambda i: hook(("fwd", i))
        with pytest.raises(Exception) as ei:
            apply(op, x[op.order])
        return ei.value

    want = run(JCSR, jst.build_streamed_operand, JInjector, JSpec, JRetry,
               lambda op, x: np.asarray(jst.streamed_spmm(op.fwd, op.bwd, jnp.asarray(x))))
    got = run(CSRGraph, build_streamed_operand, FaultInjector, FaultSpec, RetryPolicy,
              lambda op, x: streamed_spmm(op.fwd, op.bwd, torch.from_numpy(x)))
    assert isinstance(got, StreamFetchError)
    assert (got.strip, got.shard, got.name, got.attempts) == (0, 7, "fwd", 2)
    msg = str(got)
    assert "strip 0" in msg and "'fwd'" in msg and "shard 7" in msg and "2 attempt" in msg
    assert msg in str(want)  # JAX's message, word for word, inside its XLA error


def test_stream_fetch_error_message_fields():
    e = StreamFetchError(strip=3, shard=1, name="bwd",
                         cause=OSError("pinned read failed"), attempts=4)
    assert e.strip == 3 and e.shard == 1 and e.name == "bwd"
    assert "strip 3" in str(e) and "4 attempt" in str(e)


@pytest.mark.parametrize("card", [False, True], ids=["blocks", "column-stream"])
def test_corrupted_strip_raises_checksum_error(card):
    """``verify_fetch=True``: a flipped bit in a strip's blocks (what a CPU
    fetch reads) or in its packed column stream (what a card fetch
    copies) fails the fetch with ``StripChecksumError`` naming the strip,
    inside the ``StreamFetchError`` once the retries are spent; a clean
    strip passes."""
    rng = np.random.default_rng(0)
    op = build_streamed_operand(CSRGraph(**_stream_graph(rng)), "sum", k_shards=2,
                                budget_bytes=4096, verify_fetch=True,
                                retry=RetryPolicy(max_retries=1, base_delay_s=1e-5))
    strips = op.bwd
    assert strips.column_checksums.shape == (strips.n_strips,)
    strips.fetch(2, card)  # clean
    if card:
        c = strips.columns[2]
        strips.packed[c.offset + c.sections[3] + 1] ^= 0x10  # a value's byte
    else:
        strips.blocks[2].reshape(-1).view(np.uint8)[5] ^= 0x10
    with pytest.raises(StreamFetchError) as ei:
        strips.fetch(2, card)
    assert isinstance(ei.value.cause, StripChecksumError)
    assert ei.value.cause.strip == 2 and ei.value.attempts == 2
    assert "strip 2 of operand 'bwd' failed checksum" in str(ei.value)
    strips.fetch(1, card)  # its neighbours are untouched
    if not card:
        with pytest.raises(StreamFetchError, match="strip 2"):
            x = torch.ones(64, 3, requires_grad=True)
            streamed_spmm(op.fwd, op.bwd, x).sum().backward()  # bwd: in the backward


# ---------------------------------------------------------------------------
# bsr_spmm's accumulate mode
# ---------------------------------------------------------------------------


def _split_strips(seed=0):
    """A strip cut of a small graph whose boundaries land inside block-rows."""
    ds = generate_dataset("corafull", scale=0.008, seed=seed)
    bsr = csr_to_bsr(ds.graph.sym_normalized(), br=8, bc=32)
    strips = HostStrips.from_bsr(bsr, 13 * 1024)
    assert _splits_a_row(strips)
    return strips


def test_accumulate_mode_adds_into_out_on_the_cpu():
    """The accumulate mode's plain version, ``bsr_spmm_accum_ref``, gives
    ``y + A_s·X`` and leaves ``y`` as it was; strip after strip it sums to
    the whole operand's product, a split block-row included. The kernel's
    wrapper, ``bsr_spmm_accumulate``, takes CUDA tensors only."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_accumulate, nonzero_columns

    strips = _split_strips()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (strips.n_cols_padded, 5)).astype(np.float32))
    y0 = torch.randn(strips.n_rows_padded, 5, generator=torch.Generator().manual_seed(2))
    y = y0.clone()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for s in range(strips.n_strips):
        before = y.clone()
        out = bsr_spmm_accum_ref(y, t(strips.rows[s]), t(strips.cols[s]),
                                 t(strips.blocks[s]), x, strips.n_rows_padded)
        assert torch.equal(y, before)
        assert torch.equal(out, before + bsr_spmm_ref(
            t(strips.rows[s]), t(strips.cols[s]), t(strips.blocks[s]), x,
            strips.n_rows_padded))
        y = out
    whole = bsr_spmm_ref(t(strips.rows.reshape(-1)), t(strips.cols.reshape(-1)),
                         t(strips.blocks.reshape(-1, 8, 32)), x, strips.n_rows_padded)
    torch.testing.assert_close(y - y0, whole, atol=1e-5, rtol=0)
    nzc = nonzero_columns(t(strips.rows[0]), t(strips.cols[0]), t(strips.blocks[0]),
                          strips.n_rows_padded)
    with pytest.raises(ValueError, match="launches on the card"):
        bsr_spmm_accumulate(nzc, x, y)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_accumulate_kernel_on_a_split_row():
    """Each strip's accumulate launch (its column stream alone on the card)
    within 1e-5 of its plain version on the same y, the rows a strip
    boundary splits included; the whole pass equal to the resident
    ``bsr_spmm`` within 1e-5."""
    from repro_torch.kernels.bsr_spmm import bsr_spmm_accumulate, nonzero_columns

    dev = _card()
    strips = _split_strips()
    x = torch.randn(strips.n_cols_padded, 40, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    y = torch.randn(strips.n_rows_padded, 40, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    y0 = y.clone()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    n0 = bsr_spmm_accumulate.launches
    for s in range(strips.n_strips):
        c = strips.columns[s]
        nzc = c.unpack(strips.packed[c.offset:c.offset + c.nbytes].to(dev), 8,
                       strips.n_rows_padded // 8)
        want = y + bsr_spmm_ref(t(strips.rows[s]), t(strips.cols[s]),
                                t(strips.blocks[s]), x, strips.n_rows_padded)
        bsr_spmm_accumulate(nzc, x, y)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, want, atol=1e-5, rtol=0)
    assert bsr_spmm_accumulate.launches - n0 == strips.n_strips
    rows, cols = t(strips.rows.reshape(-1)), t(strips.cols.reshape(-1))
    blocks = t(strips.blocks.reshape(-1, 8, 32))
    keep = torch.ones_like(rows, dtype=torch.bool)
    keep[strips.n_blocks:] = False  # the whole stream without strip padding
    rows, cols, blocks = rows[keep].contiguous(), cols[keep].contiguous(), blocks[keep].contiguous()
    resident = bsr_spmm(rows, cols, blocks, x, strips.n_rows_padded,
                        nzc=nonzero_columns(rows, cols, blocks, strips.n_rows_padded))
    torch.testing.assert_close(y - y0, resident, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_streamed_matches_resident_on_the_card():
    """``streamed_spmm`` on the card (copies on the side stream, the
    accumulate kernel a strip, no plain version) against the resident
    product and its transpose, forward and gradient within 1e-5."""
    from repro_torch.kernels import bsr_spmm as mod

    dev = _card()
    ds = generate_dataset("corafull", scale=0.02, seed=0)
    op = build_streamed_operand(ds.graph, "gcn", k_shards=4, budget_bytes=96 * 1024)
    assert op.fwd.n_strips > 2
    x = torch.randn(op.n_nodes, 33, device=dev, requires_grad=True,
                    generator=torch.Generator(device=dev).manual_seed(0))
    n0 = mod.bsr_spmm_accumulate.launches
    y = streamed_spmm(op.fwd, op.bwd, x)
    y.square().sum().backward()
    torch.cuda.synchronize()
    assert mod.bsr_spmm_accumulate.launches - n0 == op.fwd.n_strips + op.bwd.n_strips
    xc = x.detach().cpu().requires_grad_(True)
    yc = streamed_spmm(op.fwd, op.bwd, xc)
    yc.square().sum().backward()
    torch.testing.assert_close(y.detach().cpu(), yc.detach(), atol=1e-5, rtol=0)
    torch.testing.assert_close(x.grad.cpu(), xc.grad, atol=1e-4, rtol=1e-5)
