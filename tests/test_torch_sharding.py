"""Port parity, the sharding rules: ``distributed/sharding.py`` against the
JAX package's ``ShardingRules``, spec for spec, and
``tensor_parallel.shard_tree`` against ``NamedSharding.devices_indices_map``.

The parameter specs of all 10 architectures' trees (the port's own
``LM.init`` under ``FakeTensorMode``, JAX's ``jax.eval_shape``), their
caches' (``init_cache``, normal and long-context) and every activation
kind's, on the meshes (1, 4), (2, 2), (16, 16) and (2, 16, 16) (JAX's
``AbstractMesh``; the port's ``launch/mesh.py:Mesh``), with ``fsdp`` and
``expert_parallel_2d`` each on and off. The slices run in a subprocess
with 8 host devices, as ``tests/test_distributed.py`` runs its meshes.
``check_tp`` refuses the SSM and xLSTM configurations alone, by name,
and an MLA whose heads a model axis would split below one head.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.backends.registry import DIST_ITEM  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingRules,
    Spec,
    shard_activation,
    use_rules,
)
from repro_torch.distributed.tensor_parallel import (  # noqa: E402
    check_tp,
    gather_tree,
    shard_leaf,
    shard_tree,
)
from repro_torch.launch.mesh import Mesh, abstract_mesh  # noqa: E402
from repro_torch.launch.specs import mesh_rules  # noqa: E402
from repro_torch.runtime.checkpoint import _flatten_with_paths  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1x4": ((1, 4), ("data", "model")), "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the caches' batch and length (shapes only: nothing is allocated)
CACHE_B, CACHE_S = 32, 64
KINDS = ("tokens_bsd", "ffn_hidden", "attn_heads", "logits", "moe_expert",
         "kv_cache_seq", "no_such_kind")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh

    from repro.configs import get_config as jax_get_config
    from repro.distributed.sharding import ShardingRules as JaxRules
    from repro.models.model_zoo import build_model as jax_build_model

    return jax, AbstractMesh, jax_get_config, JaxRules, jax_build_model


def _leaves(tree) -> dict:
    """path -> shape of every array leaf (the port's host ``idx`` and
    JAX's 0-d one left out)."""
    return {path: tuple(leaf.shape) for path, leaf in _flatten_with_paths(tree)
            if hasattr(leaf, "shape") and len(leaf.shape)}


@pytest.fixture(scope="module")
def trees(jx):
    """arch -> (params, cache) path -> shape maps of both packages, which
    must agree."""
    jax = jx[0]
    out = {}
    for arch in sorted(ARCHS):
        model = build_model(get_config(arch), inner="torch")
        with FakeTensorMode():
            params = _leaves(model.init(torch.Generator().manual_seed(0), device="cpu"))
            cache = _leaves(model.init_cache(CACHE_B, CACHE_S, device="cpu"))
        jmodel = jx[4](jx[2](arch))
        jparams = _leaves(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
        jcache = _leaves(jax.eval_shape(lambda: jmodel.init_cache(CACHE_B, CACHE_S)))
        assert params == jparams, arch
        assert cache == jcache, arch
        out[arch] = (params, cache)
    return out


def _meshes(jx, name):
    shape, names = MESHES[name]
    port = Mesh(dict(zip(names, shape)), dict.fromkeys(names, 0))
    return port, jx[1](shape, names)


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_match_jax(jx, trees, mesh, fsdp, ep):
    port_mesh, jax_mesh = _meshes(jx, mesh)
    n = 0
    for arch, (params, _) in trees.items():
        ours = ShardingRules(port_mesh, get_config(arch), fsdp=fsdp, expert_parallel_2d=ep)
        theirs = jx[3](jax_mesh, jx[2](arch), fsdp=fsdp, expert_parallel_2d=ep)
        for path, shape in params.items():
            got, want = ours.param_spec(path, shape), theirs.param_spec(path, shape)
            assert isinstance(got, Spec)
            assert tuple(got) == tuple(want), (arch, path, shape)
            n += 1
    assert n > 200


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_match_jax(jx, trees, mesh, long_context):
    port_mesh, jax_mesh = _meshes(jx, mesh)
    batch = 1 if long_context else CACHE_B
    for arch, (_, cache) in trees.items():
        for fsdp, ep in ((False, False), (True, True)):
            ours = ShardingRules(port_mesh, get_config(arch), fsdp=fsdp,
                                 expert_parallel_2d=ep)
            theirs = jx[3](jax_mesh, jx[2](arch), fsdp=fsdp, expert_parallel_2d=ep)
            for path, shape in cache.items():
                got = ours.cache_spec(path, shape, long_context, batch)
                want = theirs.cache_spec(path, shape, long_context, batch)
                assert tuple(got) == tuple(want), (arch, path, shape)


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_jax(jx, mesh, ep):
    port_mesh, jax_mesh = _meshes(jx, mesh)
    for arch in sorted(ARCHS):
        ours = ShardingRules(port_mesh, get_config(arch), expert_parallel_2d=ep)
        theirs = jx[3](jax_mesh, jx[2](arch), expert_parallel_2d=ep)
        for kind in KINDS:
            for ndim in (2, 3, 4):
                got, want = ours.activation_spec(kind, ndim), theirs.activation_spec(kind, ndim)
                assert (got is None) == (want is None), (arch, kind, ndim)
                if got is not None:
                    assert tuple(got) == tuple(want), (arch, kind, ndim)


def test_tree_specs_and_batch_spec():
    """The tree walkers map every tensor leaf (the cache's host ``idx`` to
    ``None``), and the batch falls back to replication where the data
    axes do not divide it, as in JAX."""
    rules = ShardingRules(abstract_mesh(2, 2), get_config("llama3.2-1b"))
    tree = {"embed": {"table": torch.empty(8, 4)}, "segments": [[{"w_up": torch.empty(3, 4, 8)}]]}
    specs = rules.tree_param_specs(tree)
    assert specs == {"embed": {"table": ("model", None)},
                     "segments": [[{"w_up": (None, None, "model")}]]}
    assert rules.tree_cache_specs({"idx": 0, "k": torch.empty(4, 8, 2, 16)},
                                  global_batch=4) == {
        "idx": None, "k": ("data", None, "model", None)}
    assert rules.batch_spec(4) == ("data",) and rules.batch_spec(3) is None


_SLICES_CODE = """
    import json
    import jax, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.distributed.sharding import ShardingRules
    from repro.models.model_zoo import build_model
    out = {}
    for name, shape, names, arch, fsdp, ep in (
            ("2x4", (2, 4), ("data", "model"), "llama3.2-1b", True, False),
            ("1x8", (1, 8), ("data", "model"), "llama3.2-1b", False, False),
            ("2x2x2", (2, 2, 2), ("pod", "data", "model"), "dbrx-132b", True, True)):
        mesh = jax.make_mesh(shape, names)
        model = build_model(get_config(arch).reduced())
        tree = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        rules = ShardingRules(mesh, model.cfg, fsdp=fsdp, expert_parallel_2d=ep)
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        leaves = {}
        for path, leaf in flat:
            p = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            spec = rules.param_spec(p, tuple(leaf.shape))
            imap = NamedSharding(mesh, spec).devices_indices_map(tuple(leaf.shape))
            per = []
            for pos in np.ndindex(*shape):
                idx = imap[mesh.devices[pos]]
                per.append([list(pos), [[s.start or 0, leaf.shape[i] if s.stop is None
                                         else s.stop] for i, s in enumerate(idx)]])
            leaves[p] = [list(leaf.shape), per]
        out[name] = {"shape": list(shape), "names": list(names), "arch": arch,
                     "fsdp": fsdp, "ep": ep, "leaves": leaves}
    print("RESULT:" + json.dumps(out))
"""


def test_shard_tree_matches_devices_indices_map():
    """Each device's slice of every leaf, on a data x model mesh with FSDP,
    a model-only mesh, and a pod x data x model mesh with FSDP and 2D
    expert parallelism (tuples of axes on one dimension), is JAX's; and
    ``gather_tree`` of every rank's shards is the whole tree."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_SLICES_CODE)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads([ln for ln in run.stdout.splitlines()
                      if ln.startswith("RESULT:")][-1][len("RESULT:"):])
    for name, case in got.items():
        shape = dict(zip(case["names"], case["shape"]))
        rules = ShardingRules(Mesh(shape, dict.fromkeys(shape, 0)),
                              get_config(case["arch"]).reduced(), fsdp=case["fsdp"],
                              expert_parallel_2d=case["ep"])
        tree, n_sharded = {}, 0
        for path, (full, per) in case["leaves"].items():
            leaf = torch.arange(int(np.prod(full)), dtype=torch.float32).reshape(full)
            spec = rules.param_spec(path, tuple(full))
            for pos, bounds in per:
                coords = dict(zip(case["names"], pos))
                want = leaf[tuple(slice(a, b) for a, b in bounds)]
                mine = shard_leaf(leaf, spec, shape, coords)
                assert torch.equal(mine, want), (name, path, pos)
                n_sharded += mine.numel() < leaf.numel()
            node = tree
            keys = path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = leaf
        assert n_sharded > 0, name
        ranks = [shard_tree(tree, rules, dict(zip(case["names"], pos)))
                 for pos, _ in next(iter(case["leaves"].values()))[1]]
        whole = gather_tree(ranks, rules, tree)
        for (_, a), (_, b) in zip(_flatten_with_paths(whole), _flatten_with_paths(tree)):
            assert torch.equal(a, b), name


def _refused(cfg, mesh, **kw):
    with pytest.raises(NotImplementedError) as err:
        check_tp(cfg, ShardingRules(abstract_mesh(*mesh), cfg, **kw))
    assert DIST_ITEM in str(err.value)
    return str(err.value)


def test_check_tp_refuses_outside_the_slice_by_name():
    """The dense family, the mixture of experts, MLA and the encoder-decoder
    run on every mesh and under every rules ``launch/specs.py`` builds,
    FSDP and 2D expert parallelism included; the families without a
    runtime under the rules are refused by name."""
    for arch, mesh in (("llama3.2-1b", (1, 4)), ("llama3.2-1b", (2, 2)),
                       ("llama3.2-1b", (1, 8)), ("pixtral-12b", (1, 8)),
                       ("llama3.2-1b", (1, 1)), ("gemma3-1b", (1, 4)),
                       ("gemma3-1b", (1, 8)), ("granite-34b", (1, 4)),
                       ("starcoder2-3b", (1, 4)), ("llama3.2-1b", (1, 3)),
                       ("whisper-tiny", (1, 4)), ("whisper-tiny", (1, 8)),
                       ("whisper-tiny", (2, 2)), ("deepseek-v3-671b", (1, 4)),
                       ("deepseek-v3-671b", (1, 8)), ("deepseek-v3-671b", (3, 2))):
        check_tp(get_config(arch), ShardingRules(abstract_mesh(*mesh), get_config(arch)))
    # dbrx-132b's 16 experts over (data, model) where they divide it (2D),
    # over model alone where not (1D), FSDP or not; deepseek-v3-671b's 256
    # the same, its MLA heads whole on every rank
    for arch in ("dbrx-132b", "deepseek-v3-671b"):
        cfg = get_config(arch)
        for mesh, ep in (((1, 4), True), ((2, 2), True), ((1, 8), True), ((2, 4), True),
                         ((1, 4), False), ((2, 2), False), ((3, 2), True), ((1, 3), True)):
            if arch == "deepseek-v3-671b" and mesh[1] == 3:
                continue  # 3 splits its MLA heads (REFUSED)
            for fsdp in (False, True):
                check_tp(cfg, ShardingRules(abstract_mesh(*mesh), cfg, fsdp=fsdp,
                                            expert_parallel_2d=ep))
    cases = {"zamba2-7b": ["SSM layers"], "xlstm-1.3b": ["xLSTM layers"]}
    for arch, names in cases.items():
        msg = _refused(get_config(arch), (1, 4))
        assert all(n in msg for n in names), (arch, msg)
    assert "MLA" not in _refused(get_config("zamba2-7b"), (2, 2), expert_parallel_2d=True)
    llama = get_config("llama3.2-1b")
    check_tp(llama, ShardingRules(abstract_mesh(2, 2), llama, fsdp=True))
    check_tp(llama, ShardingRules(abstract_mesh(2, 2), llama, expert_parallel_2d=True))
    # the JAX package's FSDP rule turns on for pixtral-12b's training at
    # model 8, and for starcoder2-3b's at model 2; granite-34b serves with it
    for arch, shape, mesh in (("pixtral-12b", "train_4k", (1, 8)),
                              ("starcoder2-3b", "train_4k", (2, 2)),
                              ("granite-34b", "decode_32k", (2, 4)),
                              ("deepseek-v3-671b", "train_4k", (2, 2))):
        assert mesh_rules(get_config(arch), SHAPES[shape], abstract_mesh(*mesh)).fsdp
    assert not mesh_rules(get_config("pixtral-12b"), SHAPES["prefill_32k"],
                          abstract_mesh(1, 8)).fsdp


#: (architecture, mesh, rules' options, the reason's words): what check_tp
#: still refuses, one case each
REFUSED = [("zamba2-7b", (1, 4), {}, "SSM layers"),
           ("zamba2-7b", (2, 4), {"fsdp": True}, "SSM layers"),
           ("zamba2-7b", (1, 8), {}, "SSM layers"),
           ("xlstm-1.3b", (1, 4), {}, "xLSTM layers"),
           ("xlstm-1.3b", (2, 2), {"fsdp": True}, "xLSTM layers"),
           ("xlstm-1.3b", (1, 8), {}, "xLSTM layers"),
           ("deepseek-6h", (1, 4), {}, "MLA's 6 heads split below one head over model 4"),
           ("deepseek-v3-671b", (1, 3), {},
            "MLA's 128 heads split below one head over model 3")]


@pytest.mark.parametrize("arch,mesh,kw,why", REFUSED,
                         ids=[f"{a}-{d}x{m}" + ("-fsdp" if kw else "")
                              for a, (d, m), kw, _ in REFUSED])
def test_check_tp_refuses_ssm_xlstm_and_split_mla_heads(arch, mesh, kw, why):
    """SSM and xLSTM layers have no runtime under the rules yet; an MLA of
    6 heads at model 4 (its ``wq_b``, ``wkv_b`` and ``wo`` widths divide 4,
    its heads do not) would split a head, and so would deepseek-v3-671b at
    model 3 (its ``wq_b`` sharded, its ``wkv_b`` not), which no ``SHAPES``
    mesh does."""
    if arch == "deepseek-6h":
        cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(), n_heads=6,
                                  n_kv_heads=6)
    else:
        cfg = get_config(arch)
    assert why in _refused(cfg, mesh, **kw)


def test_shard_activation_without_rules_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert shard_activation(x, "tokens_bsd") is x
    with use_rules(ShardingRules(abstract_mesh(2, 1), get_config("llama3.2-1b"))):
        assert shard_activation(x, "tokens_bsd") is x  # no model axis: nothing moves
    # a marker under a model axis too: the layers placed the collectives
    with use_rules(ShardingRules(abstract_mesh(1, 4), get_config("llama3.2-1b"))):
        assert shard_activation(x, "tokens_bsd") is x
        assert shard_activation(x, "logits") is x
