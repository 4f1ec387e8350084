from repro_torch.checkpoint.checkpoint import (ShardedCheckpoint,
                                               latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)
