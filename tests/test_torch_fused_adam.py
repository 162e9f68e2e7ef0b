"""Port parity, optimizers: the plain version of ``fused_adam`` (which the
wrapper runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode, at sizes that are not multiples of its (8, 128) tile;
``fused_adam_multi`` over a mixed list of leaves (empty, 0-d, lengths not
a multiple of 4, a view at a 4-byte offset) against the plain version and
Pallas, and the errors it raises; the host's packing of a step's leaves
into launch tables (every value in exactly one chunk, tables cut at
capacity, float4 and scalar leaves); the port's ``adam`` (fused and not,
over GCN-, GAT- and GIN-shaped trees), ``adamw`` and ``sgd`` against the
JAX package's over several steps; the host-side bias correction against
the JAX formula. The Hopper kernel runs only on the card: its test is
marked ``cuda`` and skips here.

Tolerance 1e-6 absolute, the JAX suite's for its fused Adam: the same
fp32 operations in the same order, up to an ulp of ``pow``/``sqrt``."""
import bisect
import types

import numpy as np
import pytest

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # pragma: no cover - exercised only without hypothesis
    from _hypothesis_fallback import hypothesis, st

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_adam import (  # noqa: E402
    CAPACITY,
    CHUNK,
    aligned16,
    fused_adam,
    fused_adam_multi,
    pack_tables,
)
from repro_torch.kernels.ref import fused_adam_ref  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    adam,
    bias_corrected_lr,
    get_optimizer,
    tree_leaves,
    tree_map,
)

torch.set_num_threads(1)
ATOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.fused_adam import fused_adam as pallas_fused_adam
    from repro.training import optimizer as jopt

    return types.SimpleNamespace(jax=jax, jnp=jnp, fused_adam=pallas_fused_adam,
                                 opt=jopt)


def _leaf(seed, shape):
    r = np.random.default_rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(shape).astype(np.float32),
            (r.standard_normal(shape) * 0.1).astype(np.float32),
            (np.abs(r.standard_normal(shape)) * 0.01).astype(np.float32))


@pytest.mark.parametrize("shape", [(1,), (1000,), (2053,), (37, 29)])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_plain_fused_adam_matches_pallas(jx, shape, wd):
    p, g, m, v = _leaf(sum(shape), shape)
    lr_t = 0.0123
    out = fused_adam(*(torch.from_numpy(a) for a in (p, g, m, v)), lr_t,
                     beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd)
    ref = jx.fused_adam(*(jx.jnp.asarray(a) for a in (p, g, m, v)),
                        jx.jnp.float32(lr_t), weight_decay=wd, interpret=True)
    for a, b in zip(out, ref):
        assert tuple(a.shape) == shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


#: the mixed list's shapes: empty, 0-d, lengths 1, 3, 4, 5, 2,053 and 1,073
#: (37 x 29), all but two not a multiple of 4
MIXED = [(0,), (1,), (3,), (), (2053,), (4,), (37, 29), (5,)]


def _mixed(seed, device="cpu"):
    """The mixed list's (p, g, m, v) on ``device``, and one more leaf whose
    four tensors are views at a 4-byte offset into larger buffers."""
    leaves = [tuple(torch.from_numpy(np.asarray(a)).to(device)
                    for a in _leaf(seed + i, shape))
              for i, shape in enumerate(MIXED)]
    big = [torch.from_numpy(a).to(device) for a in _leaf(seed + 99, (1001,))]
    leaves.append(tuple(t[1:] for t in big))
    return leaves


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_multi_matches_plain_and_pallas(jx, wd):
    leaves = _mixed(5)
    before = [tuple(t.clone() for t in leaf) for leaf in leaves]
    launches = fused_adam.launches
    out = fused_adam_multi(*(list(x) for x in zip(*leaves)), 0.0123,
                           beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=wd)
    assert fused_adam.launches == launches  # the CPU runs the plain version
    for leaf, kept in zip(leaves, before):
        for a, b in zip(leaf, kept):
            assert torch.equal(a, b)
    for i, (p, g, m, v) in enumerate(leaves):
        got = [o[i] for o in out]
        want = fused_adam_ref(p, g, m, v, 0.0123, 0.9, 0.999, 1e-8, wd)
        for a, b in zip(got, want):
            assert a.shape == p.shape and a.dtype == torch.float32
            assert a.is_contiguous() and torch.equal(a, b)
        if p.numel() == 0:
            continue
        ref = jx.fused_adam(*(jx.jnp.asarray(t.numpy()) for t in (p, g, m, v)),
                            jx.jnp.float32(0.0123), weight_decay=wd,
                            interpret=True)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def _bad_lists(case):
    ps, gs, ms, vs = (list(x) for x in zip(*_mixed(7)))
    if case == "lengths":
        vs = vs[:-1]
    elif case == "shapes":
        gs[4] = gs[4][:-1]
    elif case == "dtypes":
        ms[2] = ms[2].double()
    elif case == "devices":
        vs[1] = torch.empty(vs[1].shape, device="meta")
    elif case == "contiguity":
        ps[6] = ps[6].t().contiguous().t()
    return ps, gs, ms, vs


@pytest.mark.parametrize("case,err,match", [
    ("lengths", ValueError, "lengths differ"),
    ("shapes", ValueError, "shapes differ"),
    ("dtypes", TypeError, "float32"),
    ("devices", ValueError, "one device"),
    ("contiguity", ValueError, "contiguous"),
])
def test_fused_adam_multi_rejects_what_the_kernel_does_not_take(case, err, match):
    with pytest.raises(err, match=match):
        fused_adam_multi(*_bad_lists(case), 0.1)


@hypothesis.given(seed=st.integers(0, 2**31 - 1), capacity=st.integers(1, 9))
@hypothesis.settings(max_examples=40, deadline=None)
def test_pack_tables_covers_every_value_once(seed, capacity):
    """Each nonempty leaf in exactly one table, in order, at most
    ``capacity`` a table; walking a table's chunks as the kernel does (the
    leaf by its starts, CHUNK values from the chunk's offset) reaches every
    value exactly once; float4 chunks only on aligned leaves, whole ones."""
    r = np.random.default_rng(seed)
    sizes = [int(n) for n in r.choice([0, 1, 2, 3, 4, 5, 7, 8, 9, 33, 1000],
                                      size=int(r.integers(0, 30)))]
    aligned = [bool(a) for a in r.integers(0, 2, size=len(sizes))]
    tables = pack_tables(sizes, aligned, capacity)
    nonempty = [i for i, n in enumerate(sizes) if n > 0]
    assert len(tables) == -(-len(nonempty) // capacity)
    assert [i for t in tables for i in t.leaves] == nonempty
    seen = {i: np.zeros(sizes[i], int) for i in nonempty}
    for t in tables:
        assert 1 <= len(t.leaves) <= capacity
        assert len(t.starts) == len(t.leaves) + 1 and t.starts[0] == 0
        assert t.vec == [aligned[i] for i in t.leaves]
        scalar_chunks = {i: 0 for i in t.leaves}
        for c in range(t.starts[-1]):
            j = bisect.bisect_right(t.starts, c) - 1
            i, e = t.leaves[j], (c - t.starts[j]) * CHUNK
            end = min(e + CHUNK, sizes[i])
            assert e < end
            seen[i][e:end] += 1
            if not (t.vec[j] and end - e == CHUNK):
                scalar_chunks[i] += 1
        for j, i in enumerate(t.leaves):
            whole, part = divmod(sizes[i], CHUNK)
            want = (part > 0) if t.vec[j] else whole + (part > 0)
            assert scalar_chunks[i] == want
    assert all((s == 1).all() for s in seen.values())


def test_pack_tables_splits_at_capacity_and_classes_alignment():
    n = 2 * CAPACITY + 5
    tables = pack_tables([3] * n, [True] * n)
    assert [len(t.leaves) for t in tables] == [CAPACITY, CAPACITY, 5]
    assert tables[2].starts == [0, 1, 2, 3, 4, 5]
    assert aligned16([0, 16, 32, 4096, 48, 64, 1 << 40])
    for k in range(7):
        for off in (4, 8, 12):
            ptrs = [256] * 7
            ptrs[k] += off
            assert not aligned16(ptrs)
    assert pack_tables([0, 0], [True, False]) == []


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"layers": [
        {"w": r.standard_normal((13, 7)).astype(np.float32),
         "b": r.standard_normal(7).astype(np.float32)},
        {"eps": np.asarray(0.1, np.float32),
         "w1": r.standard_normal((7, 3)).astype(np.float32)}]}


@pytest.mark.parametrize("name,args,kw", [
    ("adam", (0.01, 0.9, 0.999), {"fused": True}),
    ("adam", (0.01, 0.9, 0.999), {"fused": False}),
    ("adamw", (0.05, 0.8, 0.99), {"fused": True}),
    ("sgd", (0.1,), {"momentum": 0.9}),
])
def test_optimizer_steps_match_jax(jx, name, args, kw):
    """Four steps from one tree of weights and one gradient stream."""
    params_np = _tree(1)
    jkw = dict(kw, interpret=True) if kw.get("fused") else dict(kw)
    jo = jx.opt.get_optimizer(name, *args, **jkw)
    to = get_optimizer(name, *args, **kw)
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, params_np)
    tp = tree_map(torch.from_numpy, params_np)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        grads_np = jx.jax.tree_util.tree_map(
            lambda a, s=step: np.random.default_rng(s).standard_normal(
                a.shape).astype(np.float32), params_np)
        jp, js = jo.update(jx.jax.tree_util.tree_map(jx.jnp.asarray, grads_np),
                           js, jp)
        tp, ts = to.update(tree_map(torch.from_numpy, grads_np), ts, tp)
    for a, b in zip(tree_leaves(tp), jx.jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def _arch_tree(arch, seed):
    """A GAT- or GIN-shaped tree, as ``models/gnn.py:init_params`` lays
    them out: GAT's w, a_src, a_dst, b, proj a layer at 3 heads, GIN's
    eps (0-d), w1, b1, w2, b2."""
    r = np.random.default_rng(seed)
    dims, layers = [13, 12, 5], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        if arch == "GAT":
            h, dh = 3, max(d_out // 3, 1)
            shapes = {"w": (d_in, h * dh), "a_src": (h, dh), "a_dst": (h, dh),
                      "b": (d_out,), "proj": (h * dh, d_out)}
        else:
            shapes = {"eps": (), "w1": (d_in, d_out), "b1": (d_out,),
                      "w2": (d_out, d_out), "b2": (d_out,)}
        layers.append({k: r.standard_normal(s).astype(np.float32)
                       for k, s in shapes.items()})
    return {"layers": layers}


@pytest.mark.parametrize("arch", ["GAT", "GIN"])
def test_fused_adam_over_arch_trees_matches_jax(jx, arch):
    """Three steps of ``adam(fused=True)`` over the arch's tree against the
    JAX package's ``adam(fused=True)`` (Pallas in interpret mode)."""
    params_np = _arch_tree(arch, 3)
    jo = jx.opt.adam(0.01, 0.9, 0.999, weight_decay=0.01, fused=True,
                     interpret=True)
    to = adam(0.01, 0.9, 0.999, weight_decay=0.01, fused=True)
    jp = jx.jax.tree_util.tree_map(jx.jnp.asarray, params_np)
    tp = tree_map(torch.from_numpy, params_np)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads_np = jx.jax.tree_util.tree_map(
            lambda a, s=step: np.random.default_rng(10 + s).standard_normal(
                a.shape).astype(np.float32), params_np)
        jp, js = jo.update(jx.jax.tree_util.tree_map(jx.jnp.asarray, grads_np),
                           js, jp)
        tp, ts = to.update(tree_map(torch.from_numpy, grads_np), ts, tp)
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts.m) + tree_leaves(ts.v),
                    jx.jax.tree_util.tree_leaves((jp, js.m, js.v))):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_bias_corrected_lr_matches_jax_formula(jx):
    jnp = jx.jnp
    for step in (1, 2, 7, 100):
        t = jnp.float32(step)
        want = 0.01 * jnp.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)
        assert bias_corrected_lr(0.01, 0.9, 0.999, step) == pytest.approx(
            float(want), rel=1e-6)


def test_adam_update_keeps_inputs_and_counts_no_cpu_launch():
    opt = adam(0.01, fused=True)
    params = {"layers": [{"w": torch.ones(5)}]}
    state = opt.init(params)
    before = fused_adam.launches
    new, state2 = opt.update({"layers": [{"w": torch.ones(5)}]}, state, params)
    assert fused_adam.launches == before
    assert state.step == 0 and state2.step == 1  # a host count
    assert torch.equal(params["layers"][0]["w"], torch.ones(5))
    assert float(new["layers"][0]["w"][0]) < 1.0
    with pytest.raises(ValueError, match="shapes differ"):
        fused_adam(torch.ones(3), torch.ones(4), torch.ones(3), torch.ones(3), 0.1)
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb", 0.1)


@pytest.mark.cuda
def test_cuda_fused_adam_matches_plain():
    """On the card: the kernel against its plain version at 1e-6 for sizes
    1, 1,000 and 1,000,003 and weight decay 0 and 0.01, one launch each;
    the mixed list (empty and 0-d leaves, lengths not a multiple of 4, a
    view at a 4-byte offset, 1,000,003 values) in one launch, inputs kept;
    a list of 2 * CAPACITY + 5 leaves in exactly 3 launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")

    def check(leaves, wd, launches):
        kept = [tuple(t.clone() for t in leaf) for leaf in leaves]
        before = fused_adam.launches
        out = fused_adam_multi(*(list(x) for x in zip(*leaves)), 0.0123,
                               weight_decay=wd)
        torch.cuda.synchronize()
        assert fused_adam.launches == before + launches
        for i, (leaf, k) in enumerate(zip(leaves, kept)):
            assert all(torch.equal(a, b) for a, b in zip(leaf, k))
            ref = fused_adam_ref(*leaf, 0.0123, 0.9, 0.999, 1e-8, wd)
            for a, b in zip((o[i] for o in out), ref):
                assert a.shape == leaf[0].shape and a.is_contiguous()
                torch.testing.assert_close(a, b, atol=ATOL, rtol=0)

    for n in (1, 1000, 1_000_003):
        for wd in (0.0, 0.01):
            check([tuple(torch.from_numpy(a).cuda() for a in _leaf(n, (n,)))],
                  wd, 1)
    mixed = _mixed(5, "cuda")
    mixed.append(tuple(torch.from_numpy(a).cuda() for a in _leaf(8, (1_000_003,))))
    assert all(t.data_ptr() % 16 == 4 for t in mixed[-2])
    for wd in (0.0, 0.01):
        check(mixed, wd, 1)
    many = [tuple(torch.from_numpy(a).cuda() for a in _leaf(i, (1 + i % 9,)))
            for i in range(2 * CAPACITY + 5)]
    check(many, 0.01, 3)
