from milnce_tpu_torch.ops.dtw import dtw_loss, dtw_path, dtw_table  # noqa: F401
from milnce_tpu_torch.ops.softdtw_sp import softdtw_seq_parallel  # noqa: F401
