from milnce_tpu_torch.losses.dtw_losses import (  # noqa: F401
    cdtw_batch_loss, cdtw_loss, sdtw_3_loss, sdtw_cidm_loss,
    sdtw_negative_loss)
