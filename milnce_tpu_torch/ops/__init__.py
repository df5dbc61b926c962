from milnce_tpu_torch.ops.dtw import dtw_loss, dtw_path, dtw_table  # noqa: F401
