from milnce_tpu_torch.ops.dtw import dtw_loss, dtw_path, dtw_table  # noqa: F401
from milnce_tpu_torch.ops.softdtw_sp import (  # noqa: F401
    softdtw_seq_parallel, softdtw_seq_parallel_rows)
