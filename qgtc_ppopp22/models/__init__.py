from qgtc_ppopp22.models.qmodels import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
    qgin_forward,
    qgcn_golden,
    qgin_golden,
)
from qgtc_ppopp22.models.baselines import (
    init_mlp_weights,
    sage_forward,
    gin_forward,
    int8_mm,
    sparse_aggregate,
)
from qgtc_ppopp22.models.layers import (
    QAggregation,
    QGCNConv,
    QGINConv,
    QLinear,
)
