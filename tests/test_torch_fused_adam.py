"""Port parity, optimizers: the plain version of ``fused_adam`` (which the
wrapper runs for CPU tensors) against the JAX package's Pallas kernel in
interpret mode, at sizes that are not multiples of its (8, 128) tile; the
port's ``adam`` (fused and not), ``adamw`` and ``sgd`` against the JAX
package's over several steps; the host-side bias correction against the
JAX formula. The Hopper kernel runs only on the card: its test is marked
``cuda`` and skips here.

Tolerance 1e-6 absolute, the JAX suite's for its fused Adam: the same
fp32 operations in the same order, up to an ulp of ``pow``/``sqrt``."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fused_adam import fused_adam  # noqa: E402
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
    1, 1,000 and 1,000,003 and weight decay 0 and 0.01; one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for n in (1, 1000, 1_000_003):
        for wd in (0.0, 0.01):
            p, g, m, v = (torch.from_numpy(a).cuda() for a in _leaf(n, (n,)))
            before = fused_adam.launches
            out = fused_adam(p, g, m, v, 0.0123, weight_decay=wd)
            torch.cuda.synchronize()
            assert fused_adam.launches == before + 1
            ref = fused_adam_ref(p, g, m, v, 0.0123, 0.9, 0.999, 1e-8, wd)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
