from qgtc_ppopp22.utils.cache import setup_compile_cache
from qgtc_ppopp22.utils.timing import device_info, host_bench
from qgtc_ppopp22.utils.metrics import (
    Logger,
    f1_score,
    multilabel_f1,
    write_csv,
    write_json_line,
)
