from repro_torch.graph.csr import (
    BSRMatrix,
    CSRGraph,
    adaptive_bc,
    bsr_block_count,
    csr_from_dense,
    csr_from_edges,
    csr_to_bsr,
    degree_order,
    permute_graph,
    rcm_order,
    reorder_graph,
)
from repro_torch.graph.datasets import DATASET_SPECS, SyntheticSpec, generate_dataset
from repro_torch.graph.sampling import (
    BucketSpec,
    NeighborSampler,
    SampledBatch,
    SampledBlock,
    make_bucket_specs,
)
