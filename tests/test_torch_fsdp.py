"""Port parity, FSDP: ``ShardingRules(fsdp=True)``'s runtime
(``distributed/fsdp.py``) on gloo CPU ranks (one ``RankPool`` of 4) at
(data, model) = (2, 1) and (2, 2), against the JAX package's single-device
program.

The dense family's reduced cases (``tests/_torch_tp_family.py``:
starcoder2-3b's, gemma3-1b's and its 2-query-head variant) with every
leaf of two or more dimensions sharded over ``data`` too: logits, a
cached prefill and two decode steps (1e-4), the float32 loss and every
gathered gradient leaf (1e-4; each layer's leaves gathered where it runs,
the gradients reduce-scattered back and divided by the data size), one
AdamW step of the shards (1e-6) and one ``make_train_step`` (1e-4), and
every rank's leaves and caches the rules' shards. Besides: a float64
``gradcheck`` of the gather/reduce-scatter pair over ``data``, of the
layer-axis broadcast and its sum back, and of ``gather_model_cols``'
all-gather/reduce-scatter pair, each inside a replicated-in,
replicated-out composition; the dry run's rank step on a reduced FSDP
cell at (2, 2) against a rank's run of the same step (persistent bytes,
collective counts by kind); a serving step gathers and reduces nothing
back.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_tp_family as fam  # noqa: E402
from repro_torch.distributed import fsdp  # noqa: E402
from repro_torch.distributed.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    CollectiveLog,
    copy_to_model,
    gather_model_cols,
    link_bytes,
    logging_collectives,
    mean_over_data,
    reduce_from_model,
    shard_tree,
)
from repro_torch.launch.mesh import RankPool, make_mesh  # noqa: E402
from repro_torch.launch.specs import build_cell  # noqa: E402
from repro_torch.launch.step_cost import reckon, tensor_bytes  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

torch.set_num_threads(1)
MESHES = [(2, 1), (2, 2)]
#: the dry run's reduced FSDP cell
CELL = dict(batch=4, seq_len=16)


class _DataMean(torch.autograd.Function):
    """Identity forward; the gradient's mean over ``data`` backward: the
    train step's division by the data size with the assembly of a
    replicated input's gradient from every data rank's chunk."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mean_over_data([g])[0]


def _gradchecks(rules) -> dict:
    g = torch.Generator().manual_seed(5)
    d, m, n_model = rules.mesh.coords["data"], rules.mesh.coords["model"], rules.model_size
    x = torch.randn(4, 6, generator=g, dtype=torch.float64, requires_grad=True)
    stack = torch.randn(2, 3, generator=g, dtype=torch.float64, requires_grad=True)
    cols = torch.randn(2, 8, generator=g, dtype=torch.float64, requires_grad=True)
    c = torch.randn(8, generator=g, dtype=torch.float64).roll(m)  # each model rank its own
    w = 8 // n_model

    def data_pair(x):  # a leaf's rows over data, gathered where it is used
        return torch.tanh(fsdp.gather_data(_DataMean.apply(x)[2 * d:2 * d + 2], 0, "data",
                                           rules)) @ torch.ones(6, dtype=torch.float64)

    def layer_pair(s):  # layer 1 of a stack whose layer axis is over data
        local = _DataMean.apply(s)[d:d + 1]
        return torch.sin(fsdp.gather({"w": fsdp.LayerSlice(local, 1, "data")},
                                     fsdp.Plan(rules, {}), "")["w"])

    def model_pair(x):  # head columns gathered, used differently on each rank
        whole = gather_model_cols(copy_to_model(x)[..., m * w:(m + 1) * w])
        return reduce_from_model((torch.cos(whole) * c).sum(-1))

    checks = {"data": (data_pair, x), "layer": (layer_pair, stack), "model": (model_pair, cols)}
    return {k: bool(torch.autograd.gradcheck(fn, (inp,))) for k, (fn, inp) in checks.items()}


def _extras(rank, dm) -> dict:
    """The gradchecks; a serving step's collectives; at (2, 2) the dry
    run's reduced FSDP cell run for real."""
    cfg = fam.config("starcoder2")
    mesh = make_mesh(*dm)
    rules = ShardingRules(mesh, cfg, fsdp=True)
    out = {}
    with use_rules(rules):
        out["gradcheck"] = _gradchecks(rules)
        model = build_model(cfg, inner="cuda")
        full = model.init(torch.Generator().manual_seed(0), device="cpu")
        local = shard_tree(full, rules, mesh.coords)
        cache = model.init_cache(2, 8, dtype=torch.float32, device="cpu")
        log = CollectiveLog()
        with torch.no_grad(), logging_collectives(log):
            model.prefill(local, torch.zeros((2, 4), dtype=torch.long), cache)
        out["serve_counts"] = dict(log.counts)
    if dm == (2, 2):
        cell = build_cell("starcoder2-3b", "train_4k", cfg=cfg, device="cpu", mesh=mesh,
                          fsdp=True, generator=torch.Generator().manual_seed(0), **CELL)
        log = CollectiveLog()
        with logging_collectives(log):
            cell.step(*cell.args)
        out["cell_counts"] = dict(log.counts)
        out["cell_bytes"] = sum(tensor_bytes(t) for t in tree_leaves(cell.args)
                                if isinstance(t, torch.Tensor))
        out["cell_params"] = cell.persistent["params"]
    return out


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    return {name: fam.reference(name) for name in fam.NAMES}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def runs(ref, pool):
    return fam.run_meshes(pool, ref, MESHES, fsdp=True)


@pytest.fixture(scope="module")
def extras(pool):
    return {dm: pool.run(_extras, dm[0] * dm[1], (dm,)) for dm in MESHES}


CASES = [(name, dm) for name in fam.NAMES for dm in MESHES]


@pytest.mark.parametrize("name,dm", CASES)
def test_fsdp_logits_prefill_and_decode(ref, runs, name, dm):
    fam.check_logits(runs[(name, dm)], ref[name], dm)


@pytest.mark.parametrize("name,dm", CASES)
def test_fsdp_loss_and_gathered_gradients(ref, runs, name, dm):
    fam.check_grads(runs[(name, dm)], ref[name], dm, fam.rules_of(name, dm, True))


@pytest.mark.parametrize("name,dm", CASES)
def test_fsdp_adamw_step_of_the_shards(ref, runs, name, dm):
    fam.check_adam(runs[(name, dm)], ref[name], dm, fam.rules_of(name, dm, True))


@pytest.mark.parametrize("name,dm", CASES)
def test_fsdp_shapes_follow_the_rules(ref, runs, name, dm):
    rules = fam.rules_of(name, dm, True)
    fam.check_shapes(runs[(name, dm)], ref[name], rules, name)
    # every leaf of two or more dimensions has a data axis: its rank holds a
    # half of it at (2, 1), a quarter at (2, 2) where model shards it too
    for path, leaf in fsdp._flatten_with_paths(params_from_jax(ref[name].params, "cpu")):
        if leaf.dim() >= 2:
            assert "data" in rules.param_spec(path, tuple(leaf.shape)), path


@pytest.mark.parametrize("dm", MESHES)
def test_fsdp_collectives_gradcheck_float64(extras, dm):
    for out in extras[dm]:
        assert out["gradcheck"] == {"data": True, "layer": True, "model": True}


@pytest.mark.parametrize("dm", MESHES)
def test_fsdp_serving_gathers_and_reduces_nothing_back(extras, dm):
    for out in extras[dm]:
        assert out["serve_counts"]["all-gather"] > 0
        assert "reduce-scatter" not in out["serve_counts"]


def test_fsdp_dryrun_rank_step_matches_the_ranks(extras):
    """The dry run's (2, 2) FSDP rank step on the reduced starcoder2 train
    cell: its persistent bytes are the rank's shards' (about a quarter of
    the whole parameters, Adam's state with them), its collective counts
    by kind what a CPU rank's log read running the same step."""
    cfg = fam.config("starcoder2")
    cell = build_cell("starcoder2-3b", "train_4k", cfg=cfg, device="meta", mesh=(2, 2),
                      fsdp=True, **CELL)
    _, cost = reckon(cell.step, *cell.args)
    rank0 = extras[(2, 2)][0]
    assert cell.persistent_bytes == rank0["cell_bytes"]
    assert cell.persistent["params"] == rank0["cell_params"]
    whole = build_cell("starcoder2-3b", "train_4k", cfg=cfg, device="meta", **CELL)
    assert cell.persistent["params"] < 0.3 * whole.persistent["params"]
    assert cost.collective_counts == rank0["cell_counts"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(cost.collective_counts)
    # remat re-gathers a layer in the backward: more gathers than reduce-scatters
    assert cost.collective_counts["all-gather"] > cost.collective_counts["reduce-scatter"]


@pytest.mark.parametrize("n,share", [(2, 0.5), (4, 0.75), (8, 0.875)])
def test_link_bytes_of_a_reduce_scatter(n, share):
    """A ring reduce-scatter sends (n-1)/n of its operand one way."""
    assert link_bytes("reduce-scatter", 1000.0, n) == pytest.approx(1000.0 * share)
    log = CollectiveLog()
    log.add("reduce-scatter", 1000, n=n)
    assert log.link_bytes == pytest.approx(1000.0 * share)
