"""Port parity, the flash attention kernel: the plain version
``flash_attention_ref`` (which the wrapper runs for CPU tensors) against
the JAX package's Pallas kernel ``flash_attention`` in interpret mode, at
the JAX suite's shapes, block shapes and causal settings, Tq != Tk causal
included (the Pallas kernel aligns the causal mask top-left, and so does
the port); against the JAX package's jnp oracle where the two alignments
agree (Tq == Tk, or no mask); grouped KV heads against repeated heads; the
wrapper's checks. The Hopper kernel runs only on the card: its tests are
marked ``cuda`` and skip here.

Tolerances are the JAX suite's: 2e-5 in float32 (the same float32
operations in another order: the plain softmax takes each row's true max,
the kernels the online recurrence), 3e-5 for the property case, 5e-2 in
bfloat16 (the output rounded to bfloat16)."""
try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # seeded-random fallback loop (no collection error)
    from _hypothesis_fallback import hypothesis, st
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    HEADS_PER_CTA,
    _heads_per_cta,
    flash_attention,
)
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side. Imported here, not at module level, so the
    card-marked tests also run where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro.kernels.ref import flash_attention_ref as jax_ref

    return types.SimpleNamespace(jax=jax, jnp=jnp, flash=pallas_flash, ref=jax_ref)


def _qkv(seed, b, h, tq, tk, d, hkv=None):
    r = np.random.default_rng(seed)
    hkv = h if hkv is None else hkv
    return (r.standard_normal((b, h, tq, d)).astype(np.float32),
            r.standard_normal((b, hkv, tk, d)).astype(np.float32),
            r.standard_normal((b, hkv, tk, d)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


SHAPES = [(2, 2, 16, 16, 8), (1, 3, 33, 33, 16), (2, 1, 64, 64, 32),
          (1, 2, 40, 72, 8), (1, 2, 24, 40, 256), (1, 2, 40, 24, 112)]


@pytest.mark.parametrize("b,h,tq,tk,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(jx, b, h, tq, tk, d, causal):
    """Every shape of the JAX suite's ``test_flash_matches_ref``, causal
    with Tq != Tk too, gemma3-1b's head width 256 and zamba2-7b's 112,
    against the Pallas kernel itself."""
    q, k, v = _qkv(b * 100 + tq, b, h, tq, tk, d)
    got = flash_attention(*_t(q, k, v), causal=causal)
    want = jx.flash(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal,
                    bq=16, bk=16, interpret=True)
    assert tuple(got.shape) == (b, h, tq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tq,tk", [(5, 40), (40, 5), (72, 40)])
def test_causal_is_top_left_unlike_the_jax_oracle(jx, tq, tk):
    """Tq != Tk, causal: the Pallas kernel (and the port) let query row i
    see keys 0..i; the JAX package's jnp oracle aligns the mask
    bottom-right (``tril(k=Tk-Tq)``) and computes another function."""
    q, k, v = _qkv(tq + tk, 1, 2, tq, tk, 16)
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    jq = tuple(jx.jnp.asarray(a) for a in (q, k, v))
    kernel = np.asarray(jx.flash(*jq, causal=True, bq=8, bk=8, interpret=True))
    oracle = np.asarray(jx.ref(*jq, causal=True))
    np.testing.assert_allclose(got, kernel, **TOL)
    assert np.abs(got - oracle).max() > 1e-2
    # row 0 sees key 0 alone: its output is v's first row
    np.testing.assert_allclose(got[:, :, 0], v[:, :, 0], **TOL)


@pytest.mark.parametrize("tq,tk,causal", [(16, 16, True), (33, 33, True),
                                          (40, 72, False), (72, 40, False)])
def test_plain_matches_jax_oracle_where_alignments_agree(jx, tq, tk, causal):
    q, k, v = _qkv(tq * tk, 2, 2, tq, tk, 8)
    got = flash_attention_ref(*_t(q, k, v), causal=causal)
    want = jx.ref(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 8), (32, 16)])
def test_block_shapes(jx, bq, bk):
    """The JAX suite's block shapes: the Pallas kernel's tiling changes its
    summation order, not its function."""
    q, k, v = _qkv(bq * bk, 1, 2, 48, 48, 16)
    got = flash_attention(*_t(q, k, v), causal=True)
    want = jx.flash(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
                    bq=bq, bk=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16(jx):
    q, k, v = _qkv(7, 1, 2, 32, 32, 16)
    tq_, tk_, tv_ = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = flash_attention(tq_, tk_, tv_, causal=True)
    jb = tuple(jx.jnp.asarray(a).astype(jx.jnp.bfloat16) for a in (q, k, v))
    want = jx.flash(*jb, causal=True, bq=16, bk=16, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@hypothesis.given(
    t=st.integers(4, 48),
    d=st.sampled_from([8, 16]),
    seed=st.integers(0, 2**31 - 1),
)
@hypothesis.settings(max_examples=10, deadline=None)
def test_property(jx, t, d, seed):
    q, k, v = _qkv(seed, 1, 1, t, t, d)
    got = flash_attention(*_t(q, k, v), causal=True).numpy()
    want = jx.flash(*(jx.jnp.asarray(a) for a in (q, k, v)), causal=True,
                    bq=16, bk=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-5, rtol=3e-5)
    # rows attend only to the past: perturbing the last key changes nothing
    k2, v2 = k.copy(), v.copy()
    k2[:, :, -1] = 0.0
    v2[:, :, -1] = 0.0
    got2 = flash_attention(*_t(q, k2, v2), causal=True).numpy()
    np.testing.assert_allclose(got[:, :, :-1], got2[:, :, :-1], atol=3e-5,
                               rtol=3e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_grouped_kv_equals_repeated_heads(causal):
    """Query head h reads KV head h // (H // Hkv): the same as the plain
    attention with every KV head repeated H // Hkv times."""
    q, k, v = _t(*_qkv(3, 2, 8, 19, 23, 16, hkv=2))
    got = flash_attention(q, k, v, causal=causal)
    rep = [t.repeat_interleave(4, dim=1) for t in (k, v)]
    want = flash_attention(q, *rep, causal=causal)
    torch.testing.assert_close(got, want, **TOL)


def test_wrapper_checks_and_executor():
    q, k, v = _t(*_qkv(5, 1, 2, 8, 8, 24))
    with pytest.raises(ValueError, match="D=24 is not built"):
        flash_attention(q, k, v)
    q, k, v = _t(*_qkv(5, 1, 3, 8, 8, 16, hkv=2))
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention(q, k, v)
    q, k, v = _t(*_qkv(5, 1, 2, 8, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match=r"\[B, H, T, D\]"):
        flash_attention(q[0], k[0], v[0])
    before = flash_attention.launches
    got = tops._executor("cuda", "flash")(q, k, v, causal=True)
    assert flash_attention.launches == before  # CPU tensors: the plain version
    torch.testing.assert_close(got, tops._executor("torch", "flash")(q, k, v, causal=True))
    assert set(HEAD_DIMS) == {8, 16, 32, 64, 112, 128, 256}


@pytest.mark.parametrize("group,want", [(1, 1), (2, 2), (3, 1), (4, 4), (6, 2),
                                        (8, HEADS_PER_CTA), (32, HEADS_PER_CTA)])
def test_heads_per_cta_default_divides_the_group(group, want):
    """The query heads of a KV group a CTA serves: the largest power of two
    up to ``HEADS_PER_CTA`` that divides the group."""
    assert HEADS_PER_CTA == 4
    assert _heads_per_cta(group) == want


# ---------------------------------------------------------------------------
# On the card: the Hopper kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", [
    (2, 2, 2, 16, 16, 8, True), (1, 3, 3, 33, 33, 16, False),
    (1, 2, 2, 40, 72, 32, True), (1, 2, 2, 72, 40, 32, True),
    (2, 8, 2, 130, 130, 64, True), (1, 4, 1, 1, 70, 128, False),
    (1, 4, 4, 1000, 1000, 64, True), (2, 4, 2, 65, 129, 128, False),
    (1, 4, 1, 100, 100, 256, True), (2, 4, 1, 65, 129, 256, False),
    # the ranks of tensor parallelism: starcoder2-3b at model 4 (6 query
    # heads over one KV head) and 8 (3), gemma3-1b's global layer at model 4
    (2, 6, 1, 260, 260, 128, True), (2, 3, 1, 130, 130, 128, True),
    (2, 1, 1, 130, 130, 256, True)])
def test_cuda_kernel_matches_plain(b, h, hkv, tq, tk, d, causal):
    """fp32 within 2e-5, one launch, a repeat bitwise equal; bf16 copies
    within 5e-2."""
    dev = _cuda()
    q, k, v = (t.to(dev) for t in _t(*_qkv(tq + d, b, h, tq, tk, d, hkv=hkv)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got_b = flash_attention(qb, kb, vb, causal=causal)
    want_b = flash_attention_ref(qb, kb, vb, causal=causal)
    assert got_b.dtype == torch.bfloat16
    torch.testing.assert_close(got_b.float(), want_b.float(), **BF16_TOL)


@pytest.mark.cuda
def test_cuda_kernel_reads_strided_views():
    """The LM's [B, T, H, D] projections, read through transpose(1, 2)
    views without a copy, and a KV view of a longer cache."""
    dev = _cuda()
    r = np.random.default_rng(11)
    q = torch.from_numpy(r.standard_normal((2, 50, 8, 64)).astype(np.float32)).to(dev)
    cache = torch.from_numpy(r.standard_normal((2, 2, 90, 2, 64)).astype(np.float32)).to(dev)
    k, v = cache[0, :, :50], cache[1, :, :50]  # [B, T, Hkv, D] views
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = flash_attention(*args, causal=True)
    want = flash_attention_ref(*(a.contiguous() for a in args), causal=True)
    torch.testing.assert_close(got, want, **TOL)
    assert got.transpose(1, 2).is_contiguous()
    with pytest.raises(ValueError, match="last axis"):
        flash_attention(args[0].transpose(2, 3).contiguous().transpose(2, 3),
                        *args[1:])


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` starting one element past a 16-byte
    boundary, so no row is aligned for cp.async."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_tiles_ragged_groups_and_layouts(d, group, causal):
    """Every built D, KV groups of 1, 2, 4 and 8 heads, Tq and Tk that are
    multiples of neither the query tile (128, or 128/hp rows a head for
    the group's hp = 1, 2, 4 and 4 heads a CTA) nor the 64-key tile: fp32
    within 2e-5 of the plain version, and a repeat bitwise equal; the same
    inputs as strided [B, T, H, D] views, and misaligned (the synchronous
    path), equal to the aligned result bitwise; bfloat16 within 5e-2."""
    dev = _cuda()
    h, tq, tk = 8, 150, 97 if causal else 201
    q, k, v = (t.to(dev) for t in _t(*_qkv(d + group, 2, h, tq, tk, d, hkv=h // group)))
    want = flash_attention_ref(q, k, v, causal=causal)
    got = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    torch.testing.assert_close(flash_attention(*views, causal=causal), got,
                               rtol=0, atol=0)
    slow = [_misaligned(x) for x in (q, k, v)]
    assert all(x.data_ptr() % 16 for x in slow)
    torch.testing.assert_close(flash_attention(*slow, causal=causal), got,
                               rtol=0, atol=0)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    got_b = flash_attention(qb, kb, vb, causal=causal)
    assert torch.equal(got_b, flash_attention(qb, kb, vb, causal=causal))
    torch.testing.assert_close(got_b.float(),
                               flash_attention_ref(qb, kb, vb, causal=causal).float(),
                               **BF16_TOL)
