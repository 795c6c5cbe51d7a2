from qgtc_ppopp22.graph.csr import CSRGraph, from_edges
from qgtc_ppopp22.graph.datasets import (
    DATASET_STATS,
    GraphDataset,
    load_dataset,
    load_npz,
    synthesize,
)
from qgtc_ppopp22.graph.partition import (
    edge_cut_fraction,
    get_partition_list,
)
from qgtc_ppopp22.graph.batching import (
    ClusterBatch,
    ClusterBatcher,
    batch_labels,
)
