"""Port parity, the launch tooling for one card (``repro_torch/launch/``:
``roofline.py``, ``step_cost.py``, ``specs.py``, ``dryrun.py``,
``report.py``) against the JAX package's (``repro/launch/``).

- ``SHAPES``, ``cell_is_runnable`` and ``model_flops_for_cell`` equal
  JAX's for all 40 (arch × shape) cells.
- The FLOPs ``StepCost`` counts over a reduced cell's step equal those
  ``repro.launch.jaxpr_flops`` counts in the JAX step at the same
  configuration and shapes, but for named closed-form terms: JAX's
  ``dot_general``s without a contracting dimension (outer and elementwise
  products, which the port runs as broadcast multiplies that
  ``torch.utils.flop_counter`` does not count); in prefill, JAX's logits at
  every position (the port unembeds the last), its causal attention over
  the whole T x S cache (the flash kernel counts the visible pairs) and
  the mLSTM's ``inter_n`` contraction (the port multiplies and sums). The
  training steps of the chunked recurrent blocks agree within 1%: there
  JAX also contracts some elementwise products' gradients.
- The sampled loops (``models/loops.py``) count what every step counts.
- A step's simulated peak over ``meta`` tensors equals the live-storage
  peak the same mode tracks over real CPU tensors, and the bytes held
  equal a real init's.
- The flash and Adam operators' shape-only versions keep the wrappers'
  shape, dtype and stride contract; a kernel without one raises on meta.
  Only value-less tensors, or a watching dispatch mode, take the
  operators. A reckoned flash call counts its FLOPs at its inputs' dtype;
  a reckoned Adam step counts the launches the wrapper makes (one for
  every ``CAPACITY`` nonempty leaves).
- One full-width cell through the command line gives a well-formed record.

Every reckoning here runs on the CPU at a reduced width, or over meta
tensors."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import cell_is_runnable as jax_cell_is_runnable  # noqa: E402
from repro.launch.jaxpr_flops import jaxpr_flops  # noqa: E402
from repro.launch.roofline import model_flops_for_cell as jax_model_flops  # noqa: E402
from repro.models.model_zoo import build_model as jax_build_model  # noqa: E402
from repro.models.model_zoo import make_dummy_batch as jax_dummy_batch  # noqa: E402
from repro.models.model_zoo import make_train_step as jax_train_step  # noqa: E402
from repro.training.optimizer import adamw as jax_adamw  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import cell_is_runnable  # noqa: E402
from repro_torch.kernels.bsr_spmm import bsr_spmm  # noqa: E402
from repro_torch.kernels.build import via_operator  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_cost  # noqa: E402
from repro_torch.kernels.fused_adam import CAPACITY, fused_adam_multi  # noqa: E402
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch.roofline import HBM_BYTES, model_flops_for_cell  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import StepCost, reckon  # noqa: E402
from repro_torch.models.transformer import _layer_window  # noqa: E402

torch.set_num_threads(1)

B, T = 2, 32
FAMILIES = ("llama3.2-1b", "deepseek-v3-671b", "zamba2-7b", "xlstm-1.3b", "whisper-tiny")
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def test_shapes_runnable_and_model_flops_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    cells = [(arch, shape) for arch in sorted(ARCHS) for shape in SHAPES]
    assert len(cells) == 40
    runnable = 0
    for arch, shape in cells:
        assert cell_is_runnable(arch, shape) == jax_cell_is_runnable(arch, shape)
        runnable += cell_is_runnable(arch, shape)[0]
        assert model_flops_for_cell(get_config(arch), SHAPES[shape]) == \
            jax_model_flops(jax_get_config(arch), JAX_SHAPES[shape])
    assert runnable == 33


# ---------------------------------------------------------------------------
# Counted FLOPs against the JAX step's jaxpr
# ---------------------------------------------------------------------------

def _no_contraction_flops(jaxpr) -> float:
    """JAX's ``dot_general`` FLOPs without a contracting dimension (2·|out|
    each), counted through scans and calls as ``jaxpr_flops`` counts."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            if not contract:
                total += 2.0 * int(np.prod(eqn.outvars[0].aval.shape))
        elif name == "scan":
            total += eqn.params["length"] * _no_contraction_flops(eqn.params["jaxpr"])
        else:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = eqn.params.get(key)
                if sub is not None and (hasattr(sub, "eqns") or hasattr(sub, "jaxpr")):
                    total += _no_contraction_flops(sub)
                    break
    return total


def _jax_step_jaxpr(arch: str, kind: str):
    """The JAX package's step of the reduced ``arch`` at [B, T] (a cache of
    T positions), as a jaxpr: ``make_train_step(adamw(3e-4))`` over float32
    parameters, or ``prefill`` / ``decode_step`` over bfloat16 weights and
    a bfloat16 cache, with ``make_dummy_batch``'s inputs."""
    cfg = jax_get_config(arch).reduced()
    model = jax_build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = jax_dummy_batch(cfg, B, T)
    if kind == "train":
        opt = jax_adamw(3e-4)
        return jax.make_jaxpr(jax_train_step(model, opt))(
            params, jax.eval_shape(opt.init, params), batch)
    params = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16 if s.dtype == jnp.float32
                                       else s.dtype), params)
    cache = model.init_cache(B, T, jnp.bfloat16)
    if kind == "prefill":
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        return jax.make_jaxpr(lambda p, t, c: model.prefill(p, t, c, **extra))(
            params, batch["tokens"], cache)
    return jax.make_jaxpr(model.decode_step)(params, cache, jnp.zeros((B, 1), jnp.int32))


def _causal_flash_layers(cfg) -> int:
    """The layers whose prefill self-attention is the causal flash call:
    GQA without a window, and the shared sites."""
    return sum(1 for lid, kind in enumerate(cfg.blocks)
               if (kind == "attn" and not cfg.mla and not _layer_window(cfg, lid))
               or kind == "shared_attn")


def _prefill_terms(cfg) -> dict:
    """The closed-form FLOPs JAX's prefill counts and the port's does not,
    at [B, T] with a T-position cache: the logits of the T - 1 positions
    before the last (2·D·Vpad each); the masked half of each causal
    self-attention over the cache (4·H·Dh a (query, key) pair: JAX's
    attention takes all T x S, the flash kernel's count the visible T(T+1)/2,
    S = T), over the GQA layers without a window and the shared sites; and
    each mLSTM layer's ``inter_n`` (2·H·dh a position: a contraction in
    JAX, a multiply and a sum in the port)."""
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    t_text = max(T - n_front, 8)
    causal = _causal_flash_layers(cfg)
    s = n_front + t_text
    hidden_pairs = s * s - s * (s + 1) // 2
    return {
        "logits before the last position": 2.0 * B * (s - 1) * cfg.d_model * cfg.padded_vocab(),
        "causal attention's hidden pairs": 4.0 * B * cfg.n_heads * cfg.resolved_head_dim
        * hidden_pairs * causal,
        "mLSTM inter_n": 2.0 * B * s * cfg.d_model * sum(k == "mlstm" for k in cfg.blocks),
    }


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_flops_match_jax(arch, kind):
    cfg = get_config(arch).reduced()
    cell = build_cell(arch, KINDS[kind], cfg=cfg, batch=B, seq_len=T)
    _, cost = reckon(cell.step, *cell.args, **cell.kwargs)
    jaxpr = _jax_step_jaxpr(arch, kind)
    want = jaxpr_flops(jaxpr) - _no_contraction_flops(jaxpr)
    if kind == "prefill":
        want -= sum(_prefill_terms(cfg).values())
    got = cost.total_flops()
    if kind == "train" and arch in ("zamba2-7b", "xlstm-1.3b"):
        assert abs(got - want) <= 0.01 * want, (got, want)
    else:
        assert got == want, (got, want)
    # prefill: the causal layers, and whisper's encoder (float32 frames, so
    # its cross attention's bfloat16 queries take the masked core)
    flash = _causal_flash_layers(cfg) + cfg.n_encoder_layers * cfg.is_encoder_decoder
    assert cost.launches.get("flash_attention", 0) == (flash if kind == "prefill" else 0)
    # train: one Adam launch for every CAPACITY nonempty leaves (the
    # reduced deepseek-v3-671b has more than CAPACITY)
    leaves = [t for t in jax.tree_util.tree_leaves(cell.args[0]) if t.numel()]
    adam = -(-len(leaves) // CAPACITY) if kind == "train" else 0
    assert cost.launches.get("fused_adam", 0) == adam


# ---------------------------------------------------------------------------
# Sampled loops, the simulated peak, the bytes held
# ---------------------------------------------------------------------------

SAMPLED = [("xlstm-1.3b", "train_4k", {}), ("xlstm-1.3b", "prefill_32k", {}),
           ("zamba2-7b", "prefill_32k", {}), ("llama3.2-1b", "train_4k", {"microbatches": 2})]


@pytest.mark.parametrize("arch,shape,kw", SAMPLED)
def test_sampled_loops_count_every_step(arch, shape, kw):
    """At 48 tokens (3 chunks of 16; 48 sLSTM steps) and 2 microbatches,
    the loops sampled at one step count what every step counts."""
    cfg = get_config(arch).reduced()
    runs = []
    for sample in (0, 1):
        cell = build_cell(arch, shape, cfg=cfg, batch=B, seq_len=48, **kw)
        _, cost = reckon(cell.step, *cell.args, **cell.kwargs, sample=sample)
        runs.append(cost)
    full, sampled = runs
    assert sampled.dispatched < full.dispatched
    assert sampled.flops == full.flops and sampled.bytes == full.bytes
    assert sampled.launches == full.launches
    assert sampled.peak == full.peak


REAL = [("llama3.2-1b", "train_4k"), ("llama3.2-1b", "prefill_32k"),
        ("whisper-tiny", "prefill_32k"), ("zamba2-7b", "decode_32k"),
        ("deepseek-v3-671b", "train_4k")]


@pytest.mark.parametrize("arch,shape", REAL)
def test_simulated_peak_equals_real_tensors(arch, shape):
    cfg = get_config(arch).reduced()
    got = {}
    for device in ("meta", "cpu"):
        cell = build_cell(arch, shape, cfg=cfg, batch=B, seq_len=T, device=device)
        out, cost = reckon(cell.step, *cell.args, **cell.kwargs)
        del out
        got[device] = (cell, cost)
    (mcell, meta), (ccell, cpu) = got["meta"], got["cpu"]
    assert mcell.persistent == ccell.persistent and mcell.n_params == ccell.n_params
    assert meta.peak == cpu.peak > 0
    assert meta.flops == cpu.flops and meta.bytes == cpu.bytes
    assert meta.launches == cpu.launches


def test_persistent_bytes_equal_a_real_init():
    cfg = get_config("llama3.2-1b").reduced()
    for shape in ("train_4k", "decode_32k"):
        cell = build_cell("llama3.2-1b", shape, cfg=cfg, batch=B, seq_len=T)
        real = build_cell("llama3.2-1b", shape, cfg=cfg, batch=B, seq_len=T, device="cpu")
        leaves = [t for t in jax.tree_util.tree_leaves(real.args) if isinstance(t, torch.Tensor)]
        assert cell.persistent_bytes == real.persistent_bytes == sum(
            t.numel() * t.element_size() for t in leaves)
        if shape == "train_4k":  # float32 parameters, AdamW's two moments like them
            assert cell.persistent["opt_state"] == 2 * cell.persistent["params"]
            assert cell.persistent["params"] == 4 * cell.n_params


def test_deepseek_params_initialised_beside_count_params():
    """The initialised deepseek-v3-671b (682.6 B) against ``count_params``'
    closed form (671.7 B), which counts its MTP block as dense (ROADMAP.md
    Queue 3, item 9) and leaves out the final norm's d_model scales."""
    cell = build_cell("deepseek-v3-671b", "decode_32k", batch=1)
    assert cell.n_params == 682_636_331_008
    assert cell.n_params - cell.cfg.param_count() == 10_923_802_624 + cell.cfg.d_model
    assert cell.persistent["params"] == 2 * cell.n_params  # bfloat16 weights


# ---------------------------------------------------------------------------
# The operators' shape-only versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_shape_only_keeps_the_contract(dtype, causal):
    """[B, H, Tq, D] at q's dtype, a view of a [B, Tq, H, D] tensor (the
    card's layout), on meta as on the CPU."""
    shapes = ((2, 8, 24, 64), (2, 2, 40, 64))
    outs = {}
    for device in ("meta", "cpu"):
        q = torch.randn(shapes[0], device=device).to(dtype)
        k, v = (torch.randn(shapes[1], device=device).to(dtype) for _ in range(2))
        outs[device] = flash_attention(q, k, v, causal=causal)
    want_stride = torch.empty((2, 24, 8, 64)).transpose(1, 2).stride()
    for device, out in outs.items():
        assert out.device.type == device
        assert tuple(out.shape) == shapes[0] and out.dtype == dtype
        assert out.stride() == want_stride
        assert out.transpose(1, 2).is_contiguous()


def test_adam_shape_only_keeps_the_contract():
    shapes = [(3, 5), (7,), (0,), (2, 2, 2)]
    for device in ("meta", "cpu"):
        ps, gs, ms, vs = ([torch.rand(s, device=device) for s in shapes] for _ in range(4))
        out = fused_adam_multi(ps, gs, ms, vs, 1e-3, weight_decay=0.01)
        assert [len(x) for x in out] == [len(shapes)] * 3
        for leaves in out:
            for t, s in zip(leaves, shapes):
                assert tuple(t.shape) == s and t.dtype == torch.float32
                assert t.is_contiguous() and t.device.type == device
        assert all(a is not b for a, b in zip(out[0], ps))


def test_only_value_less_tensors_or_a_mode_take_the_operators():
    from torch._subclasses.fake_tensor import FakeTensorMode

    real = torch.zeros(2)
    assert not via_operator(real)
    assert via_operator(real.to("meta"))
    with FakeTensorMode() as mode:
        fake = mode.from_tensor(real)
        assert via_operator(fake)
    assert via_operator(fake)
    with StepCost():
        assert via_operator(real)


@pytest.mark.parametrize("dtype,cls", [(torch.float32, "fp32"), (torch.bfloat16, "bf16")])
def test_reckoned_flash_counts_its_inputs_dtype(dtype, cls):
    q = torch.empty((1, 8, 40, 64), dtype=dtype, device="meta")
    k = torch.empty((1, 2, 40, 64), dtype=dtype, device="meta")
    _, cost = reckon(flash_attention, q, k, k, causal=True)
    assert dict(cost.flops) == {cls: flash_cost(1, 8, 2, 40, 40, 64, True, q.element_size())["flop"]}
    assert dict(cost.launches) == {"flash_attention": 1}


@pytest.mark.parametrize("n", [6, CAPACITY, CAPACITY + 1, 86])
def test_reckoned_adam_counts_the_wrappers_launches(n):
    """One launch for every CAPACITY nonempty leaves: xlstm-1.3b's 86 take
    two, as on the card; empty leaves take no slot."""
    sizes = [1024] * n + [0, 0]
    leaves = [[torch.empty(s, device="meta") for s in sizes] for _ in range(4)]
    _, cost = reckon(fused_adam_multi, *leaves, 1e-3)
    assert dict(cost.launches) == {"fused_adam": -(-n // CAPACITY)}
    assert cost.bytes == 28 * 1024 * n


def test_kernel_without_a_shape_only_version_raises_on_meta():
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="cuda or cpu"):
        bsr_spmm(meta(1, dtype=torch.int32), meta(1, dtype=torch.int32), meta(1, 8, 8),
                 meta(8, 4), 8)


# ---------------------------------------------------------------------------
# The command line at full width
# ---------------------------------------------------------------------------

def test_cli_decode_cell_at_full_width(tmp_path, capsys):
    """``llama3.2-1b × decode_32k``: its bf16 cache of 128 x 32,768
    positions (137.4 GB) does not fit one card; the largest batch that does
    is found; a skipped cell says why; ``report.py`` formats both."""
    out = tmp_path / "dry.jsonl"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", str(out)])
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--out", str(out)])
    ok, skipped = (json.loads(line) for line in out.read_text().splitlines())
    assert ok["status"] == "ok" and skipped["status"] == "skipped" and skipped["reason"]
    mem = ok["memory"]
    cfg = get_config("llama3.2-1b")
    kv = 2 * cfg.n_layers * 128 * 32_768 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    assert mem["persistent_bytes"]["cache"] == kv == 137_438_953_472
    assert mem["persistent_bytes"]["params"] == 2 * ok["params_init"]
    assert ok["params_init"] == 1_235_814_400 and ok["params_count"] == cfg.param_count()
    assert not mem["fits"] and 0 < mem["largest_batch"] < 128
    assert mem["largest_batch_peak_bytes"] <= HBM_BYTES < mem["peak_bytes"]
    assert ok["launches"] == {}  # decode takes no kernel of the port
    assert ok["model_flops"] == model_flops_for_cell(cfg, SHAPES["decode_32k"])
    assert ok["hlo_flops"] > ok["model_flops"] > 0 and ok["hlo_bytes"] >= ok["min_bytes"] > kv
    assert ok["dominant"] == "memory" and ok["t_collective_s"] == 0.0
    assert ok["bound_time_s"] == max(ok["t_compute_s"], ok["t_memory_s"])
    assert ok["mfu"] is None and ok["chips"] == 1
    table = report.fmt_table(str(out))
    assert "| llama3.2-1b | decode_32k | **memory**" in table and "skipped" in table
    assert f"batch ≤ {mem['largest_batch']}" in table
    picked = report.pick_hillclimb_cells(str(out))
    assert picked["worst_fraction"][:2] == ("llama3.2-1b", "decode_32k")
    assert picked["most_collective"] is None
    assert "1 ok, 0 skipped, 0 FAILED" in capsys.readouterr().out
