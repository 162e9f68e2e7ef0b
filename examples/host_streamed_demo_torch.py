"""Host-streamed shard training on the PyTorch/H100 port — graphs bigger
than device memory.

The port's counterpart of ``examples/host_streamed_demo.py``: builds a
synthetic graph whose BSR operands exceed a configured device-memory
budget, keeps the per-shard operands on the host, and trains a 2-layer
GCN with ``streamed_spmm``: strip s + 1's column stream is copied to the
card on a side stream while strip s's kernel adds its product into the
output (``runtime/streaming.py``), so at most two strips of each operand
are on the device at any point — forward and backward.

Run:  PYTHONPATH=src python examples/host_streamed_demo_torch.py [--device cpu]
(on CUDA unless given ``--device cpu``, which runs the plain versions).
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import arch_layer_fns, pipelined_value_and_grad
from repro_torch.graph.datasets import generate_dataset
from repro_torch.models.gnn import GNNConfig, LayerOps, init_params
from repro_torch.runtime.streaming import build_streamed_operand
from repro_torch.training.optimizer import adam

# the scale-out premise: operands must NOT fit this device budget
DEVICE_BUDGET_BYTES = 96 * 1024


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = generate_dataset("corafull", scale=0.02, seed=0)
    config = GNNConfig(kind="GCN",
                       layer_dims=[ds.features.shape[1], 32, ds.n_classes],
                       aggregation="gcn")

    op = build_streamed_operand(ds.graph, aggregation="gcn", k_shards=4,
                                budget_bytes=DEVICE_BUDGET_BYTES)
    total, resident = op.total_nbytes(), op.device_nbytes()
    assert total > DEVICE_BUDGET_BYTES, (
        f"demo premise broken: operands ({total}B) fit the budget")
    assert resident <= DEVICE_BUDGET_BYTES, (
        f"streamed residency ({resident}B) breaks the budget")
    print(f"graph: {ds.graph.n_rows} nodes, {ds.graph.indices.shape[0]} edges"
          f" in {len(op.shard_offsets) - 1} host shards")
    print(f"operands: {total / 1024:.0f} KiB host-resident total, budget "
          f"{DEVICE_BUDGET_BYTES / 1024:.0f} KiB, peak device residency "
          f"{resident / 1024:.0f} KiB "
          f"({op.fwd.n_strips}+{op.bwd.n_strips} strips, 2 live each); on the "
          f"card the strips' column streams: {op.card_nbytes() / 1024:.0f} KiB "
          f"of {op.pinned_nbytes() / 1024:.0f} KiB pinned")

    # train entirely in streamed (shard-contiguous) node order
    x = torch.from_numpy(ds.features[op.order]).to(device)
    labels = torch.from_numpy(ds.labels[op.order]).to(device)
    mask = torch.from_numpy(ds.train_mask[op.order]).to(device)
    denom = mask.sum().to(torch.float32).clamp(min=1.0)

    layer_ops = [LayerOps(aggregate=op.aggregate)
                 for _ in range(config.n_layers)]
    layer_fns = arch_layer_fns(config, layer_ops)
    opt = adam(0.01, fused=True)
    params = init_params(config, torch.Generator().manual_seed(0), device)
    opt_state = opt.init(params)

    for epoch in range(5):
        loss, grads = pipelined_value_and_grad(
            layer_fns, params, x, labels, mask, denom)
        with torch.no_grad():
            params, opt_state = opt.update(grads, opt_state, params)
        print(f"epoch {epoch + 1}  loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
